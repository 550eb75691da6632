"""The port's training attention against the JAX reference, on CPU:
K2 (forward with lse) and K3 (the flash backward) through their plain
versions, and the autograd Function (``FlashSDPA``) behind qkv_attention.

The JAX kernels run in interpret mode, as tests/test_flash_attention.py
runs them, with explicit small blocks so ragged q rows (padded, dO = 0,
lse = 0) and ragged kv columns (masked to p = 0) are exercised.
Tolerances: f32 forward (o and lse) 2e-5 (online vs one-shot softmax
reorders the f32 sums); f32 gradients 5e-4, the reference's own bound for
its backward kernels against the XLA vjp; bf16 2e-2, the kernels'
on-device bound (bench.py:53-66), since the plain versions round the
normalised p where the kernels round the unnormalised one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.ops.attention import _flash_sdpa as j_flash_sdpa
from sdxl_tpu.ops.attention import qkv_attention as j_qkv_attention
from sdxl_tpu.ops.flash_attention import flash_attention_bhtd as j_flash
from sdxl_tpu.ops.flash_attention import _LOG2E as J_LOG2E
from sdxl_tpu.ops.flash_attention import flash_attention_bwd_bhtd as j_flash_bwd
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.ops.attention import FlashSDPA, qkv_attention
from torch_tf32 import tf32_matmul

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)


def arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


CASES = [  # (shape, (block_q, block_k)) of the reference kernel
    ((1, 2, 200, 64), (64, 128)),    # ragged q and kv, two k blocks
    ((2, 1, 300, 128), (128, 128)),  # ragged, three q and k blocks, d=128
    ((1, 2, 256, 64), (128, 128)),   # aligned
]


@pytest.mark.parametrize("shape,blocks", CASES)
def test_lse_plain_matches_jax_kernel_f32(shape, blocks):
    q, k, v = arrays(shape, shape, shape)
    jo, jl = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *blocks,
                     return_lse=True)
    o, lse = fa.flash_attention_lse(t(q), t(k), t(v))
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=2e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def jax_bwd_f32(shape, blocks):
    """(q, k, v, do) from seed 1 and the reference's f32 kernels' (o, lse)
    and (dq, dk, dv) on them, as numpy arrays."""
    q, k, v, do = arrays(shape, shape, shape, shape, seed=1)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jo, jl = j_flash(jq, jk, jv, *blocks, return_lse=True)
    want = j_flash_bwd(jq, jk, jv, jo, jl, jnp.asarray(do), *blocks)
    return ((q, k, v, do), (np.asarray(jo), np.asarray(jl)),
            tuple(np.asarray(w) for w in want))


@pytest.mark.parametrize("shape,blocks", CASES)
def test_bwd_plain_matches_jax_kernels_f32(shape, blocks):
    (q, k, v, do), (jo, jl), want = jax_bwd_f32(shape, blocks)
    got = fa.flash_attention_bwd(t(q), t(k), t(v), t(jo), t(jl), t(do))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=0, err_msg=name)


def test_lse_and_bwd_plain_match_jax_kernels_bf16():
    shape, blocks = (1, 2, 200, 64), (64, 128)
    q, k, v, do = arrays(shape, shape, shape, shape, seed=2)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jo, jl = j_flash(jq, jk, jv, *blocks, return_lse=True)
    want = j_flash_bwd(jq, jk, jv, jo, jl, jdo, *blocks)
    bf = torch.bfloat16
    o, lse = fa.flash_attention_lse(t(q, bf), t(k, bf), t(v, bf))
    assert o.dtype == bf and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=2e-2, rtol=0)
    got = fa.flash_attention_bwd(t(q, bf), t(k, bf), t(v, bf),
                                 t(np.asarray(jo, np.float32), bf),
                                 t(np.asarray(jl)), t(do, bf))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == bf
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=2e-2,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("tq,c,h", [
    (1024, 128, 2),   # routed to flash: K2 forward, K3 backward
    (988, 128, 2),    # routed, ragged
])
def test_qkv_attention_grads_match_jax(tq, c, h):
    """Grads through the port's qkv_attention (FlashSDPA) against
    jax.grad through the reference's (its custom VJP: the Pallas forward
    with lse and the Pallas backward, in interpret mode)."""
    q, k, v, cot = arrays(*[(1, tq, c)] * 4, seed=3)

    def j_loss(q, k, v):
        return jnp.sum(j_qkv_attention(q, k, v, None, h) * cot)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    calls = []
    orig = fa.flash_attention_bwd_plain

    def spy(*args):
        calls.append(1)
        return orig(*args)

    fa.flash_attention_bwd_plain = spy
    try:
        (qkv_attention(*leaves, None, h) * t(cot)).sum().backward()
    finally:
        fa.flash_attention_bwd_plain = orig
    assert calls == [1]  # the flash backward ran
    for leaf, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=5e-4, rtol=0, err_msg=name)


def test_wide_head_backward_matches_jax():
    """d = 512 (the VAE head width): K1 forward and the plain math's
    autograd backward, against the reference's wide-head fallback (the
    vjp of its XLA attention)."""
    shape = (1, 1, 140, 512)
    q, k, v, cot = arrays(shape, shape, shape, shape, seed=4)

    def j_loss(q, k, v):
        return jnp.sum(j_flash_sdpa(q, k, v) * cot)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    (FlashSDPA.apply(*leaves) * t(cot)).sum().backward()
    for leaf, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=5e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("d", [64, 136])
def test_gradcheck_plain_f64(d):
    """The plain K2/K3 pair (d <= 128) and the wide-head path are the
    exact gradient of the forward, checked by finite differences in f64."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1, 3, d), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(FlashSDPA.apply, (q, k, v))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prescale_q_matches_reference_bitwise(dtype):
    """qf, the rounded pre-scaled q that the wrapper forms in torch and both
    backward kernels read, bit for bit the reference's expression
    (sdxl_tpu/ops/flash_attention.py:381), at a ragged shape."""
    shape = (1, 3, 77, 64)
    q, = arrays(shape, seed=5)
    q = q * 4
    jq = jnp.asarray(q, dtype)
    want = (jq.astype(jnp.float32) * (shape[-1] ** -0.5 * J_LOG2E)).astype(
        jq.dtype)
    got = fa._prescale_q(t(q, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_no_fallback_off_the_cpu():
    """Only CPU tensors take the plain versions: any other device (here
    `meta`, which has no kernel) raises in the forward and the backward
    instead of computing anything."""
    q = torch.empty((1, 1, 8, 64), device="meta")
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_lse(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bhtd(q, q, q)


def _tiled_tf32(a, b, passes: int, tile: int = 32):
    """a @ b over the contracted axis in tiles of 32 tokens, as K3's f32
    kernels sum it: each tile's product (TF32, `passes` passes) into a
    fresh accumulator, added to the sum in f32."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for t0 in range(0, a.shape[-1], tile):
        acc = acc + tf32_matmul(a[..., t0:t0 + tile], b[..., t0:t0 + tile, :],
                                passes)
    return acc


def test_3xtf32_backward_keeps_the_f32_bound():
    """K3a and K3b's f32 d=64 route on TF32 tensor cores
    (csrc/flash_hopper_bwd.cu flash_bwd_dq_tf32, flash_bwd_dkv_tf32): the
    backward's five products on TF32 operands in three passes, split as
    the kernels split them (hi = rna(x), lo = rna(x - hi)), the logits over
    d in one sum, dq, dk and dv over tiles of 32 tokens with a fresh sum
    each, stay within 1e-3 x max(1, max|g|) and a relative L2 error of
    1e-4 of the reference's f32 kernels at a ragged T; one pass does
    not."""
    (q, k, v, do), (jo, jl), want = jax_bwd_f32(*CASES[0])
    qt, kt, vt, dot, o = (t(a) for a in (q, k, v, do, jo))
    qf = fa._prescale_q(qt)
    lse = t(jl)[..., None]
    delta = (dot * o).sum(-1, keepdim=True)
    rel = {}
    for passes in (1, 3):
        p = torch.exp2(tf32_matmul(qf, kt.transpose(-1, -2), passes) - lse)
        dz = p * (tf32_matmul(dot, vt.transpose(-1, -2), passes) - delta)
        got = (_tiled_tf32(dz, kt, passes) * 64 ** -0.5,
               _tiled_tf32(dz.transpose(-1, -2), qf, passes) / fa._LOG2E,
               _tiled_tf32(p.transpose(-1, -2), dot, passes))
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            diff = g.numpy() - w
            rel[passes, name] = np.linalg.norm(diff) / np.linalg.norm(w)
            if passes == 3:
                assert np.abs(diff).max() < 1e-3 * max(1.0, np.abs(w).max())
    for name in ("dq", "dk", "dv"):
        assert rel[3, name] < 1e-4 < rel[1, name], rel
