"""Port CLIP towers against sdxl_tpu/models/clip.py, f32 on CPU.

Tiny towers (n_state 32, 2 layers) with the reference's random init; the
weights cross over through io/bridge.py. Hidden and pooled outputs within
1e-4 (the reference's own CLIP bound is 2e-4 at full scale).
"""

import jax
import numpy as np
import pytest
import torch

from sdxl_tpu.configs import CLIPConfig
from sdxl_tpu.models.clip import clip_hidden as j_clip_hidden
from sdxl_tpu.models.clip import clip_hidden_pooled as j_clip_hidden_pooled
from sdxl_tpu.models.clip import init_clip
from sdxl_tpu_torch.io.bridge import clip_state_dict
from sdxl_tpu_torch.models.clip import (
    CLIPTextModel,
    clip_hidden,
    clip_hidden_pooled,
)
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

TOL = 1e-4


def tiny(quick_gelu):
    return CLIPConfig(n_vocab=1000, n_state=32, embed_dim=24, n_head=4,
                      n_ctx=16, n_layer=2, quick_gelu=quick_gelu)


def tower(cfg, seed=0, extra_rows=0):
    params = jax.tree.map(np.asarray, init_clip(jax.random.PRNGKey(seed), cfg))
    if extra_rows:  # textual-inversion rows appended above the vocab
        rng = np.random.default_rng(seed)
        params["token_embedding"] = np.concatenate([
            params["token_embedding"],
            rng.standard_normal((extra_rows, cfg.n_state)).astype(np.float32)
            * 0.02])
    model = CLIPTextModel(cfg)
    sd = clip_state_dict(params)
    if extra_rows:
        model.token_embedding = torch.nn.Parameter(sd["token_embedding"])
    model.load_state_dict(sd)
    return params, model


def tokens(cfg, rng, batch=2, eot=999, extra=None):
    ids = rng.integers(1, 900, (batch, cfg.n_ctx)).astype(np.int32)
    ids[:, 0] = 998  # SOT
    ids[0, 5:] = eot  # EOT then EOT padding (CLIP pads with EOT)
    ids[1, 9] = eot
    ids[1, 10:] = 0  # OpenCLIP pads with 0
    if extra is not None:
        ids[:, 3] = extra  # a pseudo-token id above the vocab
    return ids


@pytest.mark.parametrize("quick_gelu", [True, False])
def test_hidden_matches_reference(quick_gelu):
    cfg = tiny(quick_gelu)
    params, model = tower(cfg)
    ids = tokens(cfg, np.random.default_rng(0))
    want = np.asarray(j_clip_hidden(params, cfg, ids, 1))
    got = clip_hidden(model, torch.from_numpy(ids).long(), 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("quick_gelu,extra", [(True, None), (False, None),
                                              (False, 1000)])
def test_hidden_pooled_matches_reference(quick_gelu, extra):
    """Pooling picks the first highest id (the EOT); ids >= n_vocab are
    masked out of that argmax."""
    cfg = tiny(quick_gelu)
    params, model = tower(cfg, seed=1, extra_rows=2 if extra else 0)
    ids = tokens(cfg, np.random.default_rng(1), extra=extra)
    wh, wp = j_clip_hidden_pooled(params, cfg, ids, 1)
    gh, gp = clip_hidden_pooled(model, torch.from_numpy(ids).long(), 1)
    assert gp.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(gh.detach().numpy(), np.asarray(wh), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(gp.detach().numpy(), np.asarray(wp), atol=TOL,
                               rtol=0)
