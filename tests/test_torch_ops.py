"""Port ops (sdxl_tpu_torch/ops) against their JAX counterparts, f32 on CPU.

Same inputs, made from a seed with numpy, go through both; the port's conv
ops run NCHW with OIHW weights, so inputs and weights are transposed on the
way in and outputs on the way back. Tolerance 1e-5 (f32 op-order noise).

The sinusoid embeddings add f32 phase quantisation on top: the two
frameworks' f32 exp differ by one ulp on some frequencies (<= 2^-23
relative), which moves the phase t * freq by up to t * 2^-23, so their
bound is 1e-5 + max(t) * 2^-23.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdxl_tpu.ops.conv as jconv
import sdxl_tpu.ops.embeddings as jemb
import sdxl_tpu.ops.norms as jnorms
from sdxl_tpu.ops.linear import linear as j_linear
from sdxl_tpu.ops.linear import linear_nobias as j_linear_nobias
from sdxl_tpu_torch.io.bridge import unet_state_dict
from sdxl_tpu_torch.ops import conv, embeddings, linear, norms
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

TOL = 1e-5


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nchw(a):
    return t(np.transpose(a, (0, 3, 1, 2)))


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("shape", [(2, 7, 32), (3, 64)])
def test_layernorm(shape):
    rng = np.random.default_rng(0)
    x, g, b = rnd(rng, *shape) * 3 + 1, rnd(rng, shape[-1]), rnd(rng, shape[-1])
    close(norms.layernorm(t(x)), jnorms.layernorm(jnp.asarray(x)))
    close(norms.layernorm_affine(t(x), t(g), t(b)),
          jnorms.layernorm_affine(jnp.asarray(x), g, b))


@pytest.mark.parametrize("n_group,c", [(32, 64), (4, 16)])
def test_groupnorm(n_group, c):
    rng = np.random.default_rng(1)
    x = rnd(rng, 2, 6, 5, c) * 2 - 0.5
    g, b = rnd(rng, c), rnd(rng, c)
    want = jnorms.groupnorm_nhwc(jnp.asarray(x), g, b, n_group=n_group)
    close(nhwc(norms.groupnorm(nchw(x), t(g), t(b), n_group)), want)


def test_linear_and_nobias():
    rng = np.random.default_rng(2)
    x, w, b = rnd(rng, 2, 5, 24), rnd(rng, 24, 40), rnd(rng, 40)
    wt = t(w.T)
    close(linear.linear(t(x), wt, t(b)), j_linear({"w": w, "b": b}, x))
    close(linear.linear_nobias(t(x), wt), j_linear_nobias({"w": w}, x))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d(stride):
    rng = np.random.default_rng(3)
    x, w, b = rnd(rng, 2, 9, 8, 6), rnd(rng, 3, 3, 6, 10), rnd(rng, 10)
    want = jconv.conv2d({"w": w, "b": b}, jnp.asarray(x), stride=stride)
    got = conv.conv2d(nchw(x), t(np.transpose(w, (3, 2, 0, 1))), t(b), stride)
    close(nhwc(got), want)


def test_conv1x1():
    rng = np.random.default_rng(4)
    x, w, b = rnd(rng, 2, 4, 5, 6), rnd(rng, 1, 1, 6, 10), rnd(rng, 10)
    want = jconv.conv1x1({"w": w, "b": b}, jnp.asarray(x))
    got = conv.conv1x1(nchw(x), t(np.transpose(w, (3, 2, 0, 1))), t(b))
    close(nhwc(got), want)


def test_upsample_nearest_2x():
    x = np.random.default_rng(5).standard_normal((2, 3, 5, 4)).astype(np.float32)
    want = jconv.upsample_nearest_2x(jnp.asarray(x))
    np.testing.assert_array_equal(nhwc(conv.upsample_nearest_2x(nchw(x))),
                                  np.asarray(want))


def test_folded_upsample_conv_unfolds_to_the_same_op():
    """The reference folds upsample convs into 4-phase kernels; the bridge
    unfolds them and the port runs nearest-2x + conv3x3: same output."""
    rng = np.random.default_rng(6)
    x, w, b = rnd(rng, 1, 5, 6, 8), rnd(rng, 3, 3, 8, 8), rnd(rng, 8)
    folded = {k: np.asarray(v) for k, v in
              jconv.fold_upsample_conv({"w": jnp.asarray(w), "b": b}).items()}
    want = jconv.upsample2x_conv(folded, jnp.asarray(x))
    sd = unet_state_dict({"upsample": folded})
    got = conv.conv2d(conv.upsample_nearest_2x(nchw(x)),
                      sd["upsample.weight"], sd["upsample.bias"])
    close(nhwc(got), want, 2e-5)
    np.testing.assert_allclose(
        sd["upsample.weight"].numpy(), np.transpose(w, (3, 2, 0, 1)),
        atol=1e-6)


def phase_tol(t_max):
    return TOL + t_max * 2.0 ** -23


@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding(dim):
    ts = np.array([0, 1, 250, 999], np.int32)
    close(embeddings.timestep_embedding(t(ts), dim),
          jemb.timestep_embedding(jnp.asarray(ts), dim), phase_tol(999))


def test_conditioning_embedding():
    rng = np.random.default_rng(7)
    pooled = rnd(rng, 2, 32)
    size = np.array([[1024, 1024], [832, 1216]], np.int32)
    crop = np.zeros((2, 2), np.int32)
    want = jemb.conditioning_embedding(jnp.asarray(pooled), 256,
                                       jnp.asarray(size), jnp.asarray(crop),
                                       jnp.asarray(size))
    got = embeddings.conditioning_embedding(t(pooled), 256, t(size), t(crop),
                                            t(size))
    assert got.shape == (2, 32 + 6 * 256)
    close(got, want, phase_tol(1216))
