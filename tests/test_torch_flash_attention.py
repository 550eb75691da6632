"""The port's flash attention (plain version on CPU) and qkv_attention
against the JAX reference.

The JAX kernel runs in interpret mode on the CPU, as tests/test_flash_attention.py
runs it, with explicit small blocks so the ragged-q padding and the
n_valid kv masking are exercised. Tolerance 2e-5 in f32 (online vs one-shot
softmax reorders the f32 sums); 2e-2 in bf16, the kernel's on-device bound
(bench.py:53-66), since the plain version rounds the normalised p to bf16
where the kernel rounds the unnormalised one.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdxl_tpu.ops.attention import causal_mask as j_causal_mask
from sdxl_tpu.ops.attention import qkv_attention as j_qkv_attention
from sdxl_tpu.ops.flash_attention import flash_attention_bhtd as j_flash
from sdxl_tpu.ops.flash_attention import use_flash as j_use_flash
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.ops.attention import causal_mask, qkv_attention
from torch_tf32 import tf32_matmul

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)


def inputs(shape_q, shape_k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_k).astype(np.float32)
    v = rng.standard_normal(shape_k).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape,blocks", [
    ((1, 2, 200, 64), (64, 128)),     # ragged q and kv, two k blocks
    ((2, 1, 300, 128), (128, 128)),   # ragged, three k blocks, d=128
    ((1, 1, 140, 512), (32, 128)),    # VAE head width, ragged
])
def test_plain_matches_jax_kernel_f32(shape, blocks):
    q, k, v = inputs(shape, shape)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              *blocks))
    got = fa.flash_attention_bhtd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_plain_matches_jax_kernel_bf16():
    shape = (1, 2, 200, 64)
    q, k, v = inputs(shape, shape, seed=1)
    want = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 64, 128)
    got = fa.flash_attention_bhtd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2, rtol=0)


def test_short_kv_matches_jax_kernel():
    """Tq != Tk with a short kv (the 77-token context the kernel masks)."""
    q, k, v = inputs((1, 2, 160, 64), (1, 2, 77, 64), seed=2)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              64, 128))
    got = fa.flash_attention_bhtd(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


GATE_CASES = [
    (77, 77, 64, False), (4096, 77, 64, False), (1024, 77, 64, False),
    (1024, 1024, 64, True), (4096, 4096, 64, False),
    (16384, 16384, 512, False), (15808, 15808, 512, False),
    (3952, 3952, 64, False), (988, 988, 64, False), (924, 924, 64, False),
    (923, 923, 64, False), (512, 512, 64, False), (1024, 1024, 128, False),
    (1024, 1024, 512, False), (3696, 3696, 512, False),
    (3696, 3696, 384, False), (4096, 4096, 320, False),
    (4096, 4096, 32, False), (4096, 4096, 640, False),
]


@pytest.mark.parametrize("tq,tk,d,has_mask", GATE_CASES)
def test_use_flash_matches_reference_gate(tq, tk, d, has_mask):
    assert fa.use_flash(tq, tk, d, has_mask) == j_use_flash(tq, tk, d,
                                                            has_mask)


@pytest.mark.parametrize("tq,tk,c,h,masked", [
    (1024, 1024, 128, 2, False),   # routed to flash (plain version on CPU)
    (988, 988, 128, 2, False),     # routed, ragged
    (256, 77, 64, 4, False),       # cross-attention: plain math
    (77, 77, 32, 4, True),         # causal CLIP attention: plain math
])
def test_qkv_attention_matches_reference(tq, tk, c, h, masked):
    q, k, v = inputs((1, tq, c), (1, tk, c), seed=3)
    assert fa.use_flash(tq, tk, c // h, masked) == (tq == tk and not masked)
    jmask = j_causal_mask(tq) if masked else None
    want = np.asarray(j_qkv_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jmask, h))
    mask = causal_mask(tq) if masked else None
    got = qkv_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask, h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_causal_mask_matches_reference():
    np.testing.assert_array_equal(causal_mask(9).numpy(),
                                  np.asarray(j_causal_mask(9)))


def test_kernel_wrapper_has_no_silent_fallback():
    """Only CPU tensors take the plain version; any other device must
    launch the kernel or raise."""
    q = torch.empty((1, 1, 1024, 64), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bhtd(q, q, q)


def _exporters():
    """{exported C function: the sources that define it}."""
    found = {}
    for src in fa.SOURCES:
        text = (fa.CSRC / src).read_text()
        for name in re.findall(r'(?:extern "C" int|_EXPORT\()\s*(sdxl_\w+)',
                               text):
            found.setdefault(name, set()).add(src)
    return found


@pytest.mark.parametrize("routes,names,source", [
    # K1 bf16 d 64/128 and K2: the wgmma/TMA kernel, with and without lse
    ([(torch.bfloat16, 64), (torch.bfloat16, 128)],
     ["sdxl_flash_attention_bf16", "sdxl_flash_attention_lse_bf16"],
     "flash_hopper.cu"),
    # K1 bf16 d 512, and K1 and K2 f32 d 64: bf16 and 3xTF32 tensor-core
    # kernels
    ([(torch.bfloat16, 512), (torch.float32, 64)],
     ["sdxl_flash_attention_bf16_d512", "sdxl_flash_attention_f32_d64",
      "sdxl_flash_attention_lse_f32_d64"],
     "flash_hopper.cu"),
    # K1 and K2's f32 d=128 FMA route
    ([(torch.float32, 128)],
     ["sdxl_flash_attention_f32_d128", "sdxl_flash_attention_lse_f32_d128"],
     "flash_attention.cu"),
    # K1 f32 d 512: 3xTF32 on mma.sync
    ([(torch.float32, 512)], ["sdxl_flash_attention_f32_d512"],
     "flash_hopper.cu"),
    # K2 f32 d 64 alone: the 3xTF32 kernel with its lse store
    ([(torch.float32, 64)],
     ["sdxl_flash_attention_f32_d64", "sdxl_flash_attention_lse_f32_d64"],
     "flash_hopper.cu"),
    # K3a and K3b: f32 d=128 on the FMA pipes; bf16 on wgmma and TMA, f32
    # d=64 on 3xTF32 wgmma and TMA
    ([(torch.float32, 128)],
     ["sdxl_flash_attention_bwd_dq_f32_d128",
      "sdxl_flash_attention_bwd_dkv_f32_d128"],
     "flash_attention_bwd.cu"),
    ([(torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64)],
     ["sdxl_flash_attention_bwd_dq_bf16", "sdxl_flash_attention_bwd_dkv_bf16",
      "sdxl_flash_attention_bwd_dq_f32", "sdxl_flash_attention_bwd_dkv_f32"],
     "flash_hopper_bwd.cu"),
])
def test_routes_name_the_source_that_defines_them(routes, names, source):
    """The exports that these (dtype, head dim) routes take in _ROUTES (K1)
    and _TRAIN_ROUTES (K2, K3a, K3b) from `source` are `names`, and only
    `source` defines each."""
    exported = set()
    for route in routes:
        exported |= {fa._ROUTES[route]} if route in fa._ROUTES else set()
        exported |= set(fa._TRAIN_ROUTES.get(route, ()))
    assert {n for n in exported if fa._KERNELS[n][0] == source} == set(names)
    exporters = _exporters()
    for name in names:
        assert fa._KERNELS[name][0] == source
        assert exporters[name] == {source}


def _trunc_split(x: torch.Tensor):
    """x = hi + lo as the f32 d=512 route splits it: hi is x with its 13 low
    mantissa bits cleared (x truncated to TF32), lo = x - hi, which the
    tensor core truncates to TF32 in turn."""
    def trunc(y):
        return (y.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    hi = trunc(x)
    return hi, trunc(x - hi)


def _trunc_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    (a_hi, a_lo), (b_hi, b_lo) = _trunc_split(a), _trunc_split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _f32_d512_route(q, k, v, passes: int) -> torch.Tensor:
    """The f32 d=512 route's arithmetic (csrc/flash_hopper.cu
    flash_fwd_f32_d512): per 32-key tile, eight warps' partial S over 64
    head-dim columns each, summed in warp order; the base-2 online softmax;
    the tile's P V into a fresh accumulator added to O as O alpha + PV."""
    qs = q * (512 ** -0.5 * fa._LOG2E)
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    for k0 in range(0, k.shape[-2], 32):
        kt, vt = k[..., k0:k0 + 32, :], v[..., k0:k0 + 32, :]
        s = torch.zeros(q.shape[:-1] + (kt.shape[-2],))
        for w in range(8):
            cols = slice(64 * w, 64 * w + 64)
            s = s + _trunc_matmul(qs[..., cols],
                                  kt[..., cols].transpose(-1, -2), passes)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = o * alpha + _trunc_matmul(p, vt, passes)
        m = m_new
    return o / l


@pytest.mark.parametrize("d", [64, 512])
def test_3xtf32_attention_keeps_the_f32_bound(d):
    """The f32 routes on TF32 tensor cores: d=64 (flash_fwd_tf32, operands
    rounded to nearest) and d=512 (flash_fwd_f32_d512, operands truncated,
    its head-dim split and key tiles emulated). Both products of the
    attention on TF32 operands in three passes stay within 1e-3 x min(1,
    max|o|) and a relative L2 error of 1e-4 of the reference's f32 kernel;
    one pass does not."""
    shape = (1, 2, 256, 64) if d == 64 else (1, 1, 512, 512)
    q, k, v = inputs(shape, shape, seed=5)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              64 if d == 64 else 128, 128))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    rel = {}
    for passes in (1, 3):
        if d == 64:
            qs = qt * (64 ** -0.5 * fa._LOG2E)
            s = tf32_matmul(qs, kt.transpose(-1, -2), passes)
            p = torch.exp2(s - s.amax(-1, keepdim=True))
            o = tf32_matmul(p, vt, passes) / p.sum(-1, keepdim=True)
        else:
            o = _f32_d512_route(qt, kt, vt, passes)
        diff = o.numpy() - want
        rel[passes] = np.linalg.norm(diff) / np.linalg.norm(want)
        if passes == 3:
            assert np.abs(diff).max() < 1e-3 * min(1.0, np.abs(want).max())
    assert rel[3] < 1e-4 < rel[1], rel
