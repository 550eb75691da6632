"""Port UNet against sdxl_tpu/models/unet.py, f32 on CPU.

The block plan must equal the reference's for SDXL base and refiner. The
tiny UNet's weights come from the reference init and cross over through
io/bridge.py, both as the raw tree and as the production tree
(fuse_unet_qkv: fused self-attention qkv and 4-phase upsample kernels).
unet_forward within 1e-3 (the reference's UNet bound is 2e-3 at full
scale); one config routes its level-1 and middle self-attention through
flash (d=64 at 1024 tokens: the JAX kernel in interpret mode, the port's
plain version on CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.configs import SDXL_BASE_DIFFUSER, SDXL_REFINER_DIFFUSER, UNetConfig
from sdxl_tpu.models.unet import fuse_unet_qkv, init_unet
from sdxl_tpu.models.unet import precompute_cross_kv as j_precompute_cross_kv
from sdxl_tpu.models.unet import unet_block_plan as j_unet_block_plan
from sdxl_tpu.models.unet import unet_forward as j_unet_forward
from sdxl_tpu_torch.io.bridge import unet_state_dict
from sdxl_tpu_torch.models.unet import (
    UNet,
    precompute_cross_kv,
    unet_block_plan,
    unet_forward,
)
from sdxl_tpu_torch.ops.flash_attention import use_flash

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

TINY = UNetConfig(adm_in_channels=32 + 6 * 256, model_channels=32,
                  channel_mults=(1, 2, 4), n_head_channels=8,
                  transformer_depths=(1, 1, 2), context_dim=64)
# d=64 heads at 32x32 = 1024 tokens: the self-attention routes to flash
FLASH_TINY = UNetConfig(adm_in_channels=16, model_channels=64,
                        channel_mults=(1, 2), n_head_channels=64,
                        transformer_depths=(1, 1), context_dim=16,
                        transformer_levels=(1,))


def random_tree(init_fn, *args, seed=0, scale=0.02):
    """A parameter tree in the reference's exact layout (its init traced,
    not compiled) filled from numpy: weights and biases ~ N(0, scale^2),
    norm gains 1 + N(0, 0.1^2). Compiling the reference's own random init
    would cost tens of seconds per config on the CPU."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init_fn(key, *args),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "gamma":
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def plan_fields(plan):
    inp, mid, out = plan
    return ([dataclasses.astuple(s) for s in inp], dataclasses.astuple(mid),
            [dataclasses.astuple(s) for s in out])


@pytest.mark.parametrize("diffuser", [SDXL_BASE_DIFFUSER,
                                      SDXL_REFINER_DIFFUSER])
def test_block_plan_matches_reference(diffuser):
    cfg = diffuser.unet_config()
    assert plan_fields(unet_block_plan(cfg)) == plan_fields(
        j_unet_block_plan(cfg))


def run_both(cfg, fused, latent_hw, seed, use_cross_kv=False):
    params = random_tree(init_unet, cfg, jnp.float32, seed=seed)
    if fused:
        params = jax.tree.map(np.asarray, fuse_unet_qkv(params))
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, latent_hw, latent_hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, cfg.context_dim)).astype(np.float32)
    label = rng.standard_normal((2, cfg.adm_in_channels)).astype(np.float32)
    ts = np.array([999, 500], np.int32)

    def reference(params, x, ts, ctx, label):
        jkv = j_precompute_cross_kv(params, cfg, ctx) if use_cross_kv else None
        return j_unet_forward(params, cfg, x, ts, ctx, label, cross_kv=jkv)

    want = np.asarray(jax.jit(reference)(params, x, ts, ctx, label))
    model = UNet(cfg, dtype=torch.float32)
    model.load_state_dict(unet_state_dict(np_params))
    tctx = torch.from_numpy(ctx)
    with torch.no_grad():
        kv = precompute_cross_kv(model, tctx) if use_cross_kv else None
        got = unet_forward(model, torch.from_numpy(x), torch.from_numpy(ts),
                           tctx, torch.from_numpy(label), kv)
    return got.numpy(), want


@pytest.mark.parametrize("fused,use_cross_kv", [(True, True), (False, False)])
def test_unet_forward_matches_reference(fused, use_cross_kv):
    got, want = run_both(TINY, fused, 16, seed=0, use_cross_kv=use_cross_kv)
    assert got.shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_unet_forward_flash_route_matches_reference():
    assert use_flash(1024, 1024, 64, False)
    got, want = run_both(FLASH_TINY, True, 64, seed=1)
    assert got.shape == want.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
