"""Model configurations: re-exported from the JAX-free ``sdxl_tpu.configs``.

The port runs the same frozen dataclasses and SDXL presets as the
reference, so a config built for one package describes the same model in
the other.
"""

from sdxl_tpu.configs import (  # noqa: F401
    OPEN_CLIP_BIGG_CONFIG,
    SDXL_BASE_DIFFUSER,
    SDXL_EMBEDDER,
    SDXL_REFINER_DIFFUSER,
    AutoencoderConfig,
    CLIPConfig,
    DiffuserConfig,
    EmbedderConfig,
    LatentDecoderConfig,
    UNetConfig,
)
