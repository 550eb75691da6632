"""Model configurations (the port's copy of the SDXL part of sdxl_tpu/configs.py).

Frozen dataclasses with the reference's field names and defaults, and the
SDXL 1.0 presets, so a config describes the same model in both packages
(a CPU test holds ``dataclasses.asdict`` of each against the reference's).
The SD1/SD2, SD3, T5 and Flux configs wait for their slices.
"""

from __future__ import annotations

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
    # FreeU (b1, b2, s1, s2); None = off. Not ported yet.
    freeu: Optional[Tuple[float, float, float, float]] = None
    # LCM guidance-embedding width; 0 = none. Not ported yet.
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
