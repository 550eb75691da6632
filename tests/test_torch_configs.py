"""The port's own configs and BPE tokenizer against the reference's.

Configs: ``dataclasses.asdict`` of every SDXL preset and of each class's
defaults equals the reference's, field for field. Tokenizer: the token ids
of both towers' tokenizers equal the reference's (vendored merge table,
pure-Python merges) on emphasis syntax, a prompt over 77 tokens, the empty
prompt, unicode and punctuation — exact equality.
"""

import dataclasses

import pytest

import sdxl_tpu.configs as jcfg
import sdxl_tpu_torch.configs as tcfg
from sdxl_tpu.tokenizer import ClipTokenizer as JClip
from sdxl_tpu.tokenizer import OpenClipTokenizer as JOpenClip
from sdxl_tpu_torch.tokenizer import ClipTokenizer, OpenClipTokenizer

PRESETS = ["OPEN_CLIP_BIGG_CONFIG", "CLIP_VIT_L_CONFIG", "SDXL_BASE_DIFFUSER",
           "SDXL_REFINER_DIFFUSER", "SDXL_EMBEDDER", "SD15_DIFFUSER",
           "SD2_DIFFUSER", "SD21_768_DIFFUSER", "OPEN_CLIP_VITH_CONFIG",
           "SD15_VAE_SCALE"]
CLASSES = ["CLIPConfig", "UNetConfig", "DiffuserConfig", "EmbedderConfig",
           "LatentDecoderConfig", "AutoencoderConfig"]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_reference(name):
    got, want = getattr(tcfg, name), getattr(jcfg, name)
    if not dataclasses.is_dataclass(want):
        assert got == want
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", CLASSES)
def test_defaults_match_reference(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == \
        dataclasses.asdict(getattr(jcfg, name)())


@pytest.mark.parametrize("name", ["SDXL_BASE_DIFFUSER",
                                  "SDXL_REFINER_DIFFUSER", "SD15_DIFFUSER",
                                  "SD2_DIFFUSER", "SD21_768_DIFFUSER"])
def test_unet_config_matches_reference(name):
    got = getattr(tcfg, name).unet_config()
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(getattr(jcfg, name).unet_config())
    assert got.time_embed_dim == getattr(jcfg, name).unet_config() \
        .time_embed_dim


PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a (red:1.3) cat on a [wooden] table, ((masterpiece))",
    " ".join(["a very long prompt about many things"] * 12),  # > 77 tokens
    "",
    "café crème brûlée — naïve 東京 🚀 10,000 it's we'll",
    "   WHITESPACE\tand\nCASE   <|endoftext|> mixed!!",
]


@pytest.fixture(scope="module")
def tokenizers():
    return [(ClipTokenizer(), JClip(None)),
            (OpenClipTokenizer(), JOpenClip(None))]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_token_ids_match_reference(tokenizers, prompt):
    for port, ref in tokenizers:
        assert port.pad_token == ref.pad_token
        assert port.encode(prompt) == ref.encode(prompt)
        assert port.encode(prompt, add_sot=False, add_eot=False) == \
            ref.encode(prompt, add_sot=False, add_eot=False)
