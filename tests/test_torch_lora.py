"""The port's LoRA pieces against the reference, f32 on CPU: runtime
(unmerged) LoRA in the linears, target selection, init, the unfused
training layout of the UNet with factors installed, and the bridge's
factor and state_dict conversions.

Tolerances: single ops 1e-5; the UNet forward 1e-3, as in
tests/test_torch_unet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.models.unet import init_unet
from sdxl_tpu.models.unet import unet_forward as j_unet_forward
from sdxl_tpu.ops.linear import linear as j_linear
from sdxl_tpu.ops.linear import linear_nobias as j_linear_nobias
from sdxl_tpu.train.lora import init_lora as j_init_lora
from sdxl_tpu.train.lora import lora_target_paths as j_lora_target_paths
from sdxl_tpu.train.lora import path_str, set_leaves
from sdxl_tpu_torch.io.bridge import (
    factors_to_numpy,
    factors_to_torch,
    unet_state_dict,
)
from sdxl_tpu_torch.models.unet import UNet, unet_forward, unfuse_unet_qkv
from sdxl_tpu_torch.ops import linear
from sdxl_tpu_torch.train.lora import (
    clear_factors,
    init_lora,
    lora_target_paths,
    set_factors,
)
from tests.test_torch_unet import TINY, random_tree
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_runtime_lora_matches_reference(dtype):
    """y = x w + b + (x down) up, the factors cast to x's dtype."""
    rng = np.random.default_rng(0)
    x, w, b = rnd(rng, 2, 5, 24), rnd(rng, 24, 40), rnd(rng, 40)
    down, up = rnd(rng, 24, 4), rnd(rng, 4, 40)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x, jd)
    p = {"w": jnp.asarray(w, jd), "lora_down": down, "lora_up": up}
    tx, tw = t(x).to(dtype), t(w.T).to(dtype)
    pair = (t(down), t(up))
    tol = 2e-2 * np.abs(x @ w).max() if dtype == torch.bfloat16 else 1e-5
    for got, want in (
            (linear.linear(tx, tw, t(b).to(dtype), pair),
             j_linear(dict(p, b=jnp.asarray(b, jd)), jx)),
            (linear.linear_nobias(tx, tw, pair), j_linear_nobias(p, jx))):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=0)


@pytest.fixture(scope="module")
def tiny_tree():
    return jax.tree.map(np.asarray,
                        random_tree(init_unet, TINY, jnp.float32, seed=7))


@pytest.mark.parametrize("targets", ["attn", "all-linear"])
def test_target_paths_match_reference(tiny_tree, targets):
    model = unfuse_unet_qkv(UNet(TINY, dtype=torch.float32))
    want = [path_str(p) for p in j_lora_target_paths(tiny_tree, targets)]
    assert lora_target_paths(model, targets) == want
    # the fused layout offers no qkv target, as in the reference
    fused = UNet(TINY, dtype=torch.float32)
    assert not any(p.endswith("qkv") for p in
                   lora_target_paths(fused, targets))


def test_init_lora(tiny_tree):
    model = unfuse_unet_qkv(UNet(TINY, dtype=torch.float32))
    g = torch.Generator().manual_seed(0)
    flat = init_lora(model, 8, g)
    j_flat = j_init_lora(tiny_tree, 8, jax.random.PRNGKey(0))
    assert list(flat) == list(j_flat)
    for k, v in flat.items():
        assert tuple(v.shape) == j_flat[k].shape and v.dtype == torch.float32
        if k.endswith("lora_up"):
            assert not v.any()
    downs = torch.cat([v.flatten() for k, v in flat.items()
                       if k.endswith("lora_down")])
    assert abs(downs.std().item() - 1 / 8) < 0.01  # N(0, 1) / rank


def test_unet_with_factors_matches_reference(tiny_tree):
    """The training layout (unfused q/k/v, factors in the slots, cross K/V
    computed inline) against the reference's unet_forward over
    set_leaves(tree, factors) with the same nonzero factors; zero ups give
    the base model exactly; clear_factors restores it."""
    rng = np.random.default_rng(8)
    j_flat = j_init_lora(tiny_tree, 4, jax.random.PRNGKey(1),
                         targets="all-linear")
    flat = {k: rnd(rng, *v.shape) * 0.1 for k, v in j_flat.items()}
    x = rnd(rng, 2, 16, 16, 4)
    ctx, label = rnd(rng, 2, 7, TINY.context_dim), rnd(rng, 2,
                                                      TINY.adm_in_channels)
    ts = np.array([999, 500], np.int32)
    want = np.asarray(jax.jit(lambda p, f: j_unet_forward(
        set_leaves(p, f), TINY, x, ts, ctx, label))(tiny_tree, flat))

    model = unfuse_unet_qkv(UNet(TINY, dtype=torch.float32))
    model.load_state_dict(unet_state_dict(tiny_tree, fused=False))
    args = (t(x), t(ts), t(ctx), t(label))
    with torch.no_grad():
        base = unet_forward(model, *args)
        set_factors(model, factors_to_torch(flat))
        got = unet_forward(model, *args)
        zero = {k: v * 0 if k.endswith("lora_up") else v
                for k, v in factors_to_torch(flat).items()}
        set_factors(model, zero)
        assert torch.equal(unet_forward(model, *args), base)
        clear_factors(model)
        assert torch.equal(unet_forward(model, *args), base)
    assert np.abs(got.numpy() - base.numpy()).max() > 1e-2  # factors act
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_unfuse_and_bridge_layouts(tiny_tree):
    """unfuse_unet_qkv on the fused model = the unfused state_dict; both
    layouts compute the same function; factors round-trip the bridge."""
    fused = UNet(TINY, dtype=torch.float32)
    fused.load_state_dict(unet_state_dict(tiny_tree))
    unfused = unfuse_unet_qkv(UNet(TINY, dtype=torch.float32))
    unfused.load_state_dict(unet_state_dict(tiny_tree, fused=False))
    rng = np.random.default_rng(9)
    args = (t(rnd(rng, 1, 16, 16, 4)), t(np.array([10], np.int32)),
            t(rnd(rng, 1, 7, TINY.context_dim)),
            t(rnd(rng, 1, TINY.adm_in_channels)))
    with torch.no_grad():
        want = unet_forward(unfused, *args)
        np.testing.assert_allclose(unet_forward(fused, *args).numpy(),
                                   want.numpy(), atol=1e-5, rtol=0)
        unfuse_unet_qkv(fused)
        sd = fused.state_dict()
        assert sd.keys() == unfused.state_dict().keys()
        assert all(torch.equal(sd[k], v)
                   for k, v in unfused.state_dict().items())
    flat = {"a.lora_down": rnd(rng, 6, 2), "a.lora_up": rnd(rng, 2, 3)}
    back = factors_to_numpy(factors_to_torch(flat))
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
