"""Module 14, weight-only int8 / int4 quantization (ops/quant.py, the
QuantLinear module, io/quantize.py, the loaders' quantize=, FLUX.1's
t5_offload and the sample CLI's --quantize), against sdxl_tpu at tiny
configs, f32 on the CPU, where K4's wrapper runs its plain version.

- The quantizers bitwise equal to the reference's (transposed to the
  port's [d_out, d_in]) on random f32 and bf16 weights with a zero
  column; exactly representable weights round-trip exactly; the plain
  dequant bitwise equal to the reference's in f32 and bf16.
- QuantLinear against the reference's ``linear(p, x)`` on the same
  quantized dict carried across by io/bridge.py: 1e-6 relative.
- quantize_model against quantize_tree on tiny FLUX.1, MMDiT (SD3.5's
  dual attention), T5 and UNet models (fused qkv, lin_embed clamped to
  int8, the ragged-d_in fallback, a min_dim that leaves linears out):
  the same linears at the same bits, every quantized tensor bitwise.
- The quantized forwards (unet_forward, mmdit_forward, flux_forward,
  t5_encode): the Ground rules' bounds (UNet 2e-3, MMDiT and FLUX.1 1e-3
  of max|ref|, T5 2e-4).
- Requests against the reference's entry points with its draws
  injected: SDXL with the refiner (int8), SD 2.x (int4), SD3 with T5
  (int8) and FLUX.1 (int4, T5 int8); the loaders with quantize= and one
  LoRA (merged before the quantizer) bitwise as the reference loads.
- t5_offload: the conditioning bitwise the resident one's, T5 back on
  the host after the call.
- The CLI's --quantize int8 on the random SDXL path and from a native
  checkpoint (with the refiner) against the in-memory pipeline, pixel
  for pixel; a bad value refused as the reference's parser refuses it.
- Every full-width linear quantize_model makes (FLUX.1 dev / schnell,
  SD3-medium, SD3.5-large / medium, T5-XXL, SDXL base and refiner, SD
  1.5, SD 2.x) is a shape K4 takes, and the quantized bytes equal the
  reference's quantize_tree on jax.eval_shape trees.

Tiny models quantize with min_dim and the int4 group lowered on both
sides: the reference's SDXL_TPU_QUANT_MIN_DIM / _GROUP, the port's
io/quantize.py MIN_DIM / GROUP.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as st_save

import sdxl_tpu.configs as jcfg
import sdxl_tpu.io.quantize as jqz
import sdxl_tpu.ops.quant as jq
import sdxl_tpu.pipeline.flux as j_flux
import sdxl_tpu.pipeline.loader as j_loader
import sdxl_tpu.pipeline.sd3 as j_sd3
import sdxl_tpu_torch.configs as tcfg
import sdxl_tpu_torch.io.quantize as tqz
import sdxl_tpu_torch.ops.quant as tq
import sdxl_tpu_torch.pipeline.flux as t_flux
import sdxl_tpu_torch.pipeline.sd3 as t_sd3
from sdxl_tpu.models.flux import flux_forward as j_flux_forward
from sdxl_tpu.models.flux import init_flux
from sdxl_tpu.models.mmdit import init_mmdit
from sdxl_tpu.models.mmdit import mmdit_forward as j_mmdit_forward
from sdxl_tpu.models.t5 import init_t5
from sdxl_tpu.models.t5 import t5_encode as j_t5_encode
from sdxl_tpu.models.unet import fuse_unet_qkv, init_unet
from sdxl_tpu.models.unet import unet_forward as j_unet_forward
from sdxl_tpu.ops.linear import linear as j_linear
from sdxl_tpu.pipeline.pipeline import SDXLPipeline as JPipeline
from sdxl_tpu.pipeline.sampler import scaled_linear_alphas_cumprod
from sdxl_tpu.tokenizer import ClipTokenizer, OpenClipTokenizer
from sdxl_tpu_torch.io.bridge import (
    flux_state_dict,
    mmdit_state_dict,
    t5_state_dict,
    to_tensor,
    tree_to_state_dict,
    unet_state_dict,
)
from sdxl_tpu_torch.io.checkpoint import save_native_pipeline
from sdxl_tpu_torch.io.images import load_images
from sdxl_tpu_torch.models.flux import Flux, flux_forward
from sdxl_tpu_torch.models.layers import QuantLinear, init_reference_
from sdxl_tpu_torch.models.mmdit import MMDiT, mmdit_forward
from sdxl_tpu_torch.models.t5 import T5Encoder, t5_encode
from sdxl_tpu_torch.models.unet import UNet, unet_forward
from sdxl_tpu_torch.pipeline import pipeline as tpipeline
from sdxl_tpu_torch.pipeline.loader import load_pipeline, quantize_unet
from sdxl_tpu_torch.pipeline.pipeline import random_pipeline
from tests.test_flux_loader import TINY_CLIP_L as FLUX_CLIP_L
from tests.test_pipeline_e2e import TINY_REFINER, TINY_VAE
from tests.test_sd3_loader import TINY_T5, make_diffusers_mmdit_dict
from tests.test_sd3_loader import make_hf_t5_dict
from tests.test_torch_flux import FLUX, STUB_T5 as FLUX_STUB_T5
from tests.test_torch_flux import _pair as flux_pair
from tests.test_torch_flux import run_pair as flux_run_pair
from tests.test_torch_flux import JT5 as FLUX_JT5
from tests.test_torch_module12 import CLIP_H, MID_V
from tests.test_torch_module12 import _pair as sd1_pair
from tests.test_torch_module12 import _txt2img as sd1_txt2img
from tests.test_torch_module9 import (
    NEGATIVE,
    PROMPT,
    RES,
    STEPS,
    TINY_BASE,
    assert_matches,
    fused,
    inject,
    reference_draws,
    reference_tree,
    run_reference,
)
from tests.test_torch_pipeline import TINY_EMBEDDER
from tests.test_torch_sd3 import (
    MMDIT,
    STUB_T5,
    _close,
    _jcfg,
    _moved,
    assert_request,
    numpy_tree,
    port_mmdit,
    port_t5,
    run_pair,
)
from tests.torch_parity import fast_reference_compiles  # noqa: F401

# One intra-op thread: the suite runs six workers on shared cores.
torch.set_num_threads(1)

F32 = torch.float32
LIN_TOL, UNET_TOL, MODEL_TOL, T5_TOL = 1e-6, 2e-3, 1e-3, 2e-4
# the tiny models' quantizer settings (both sides): every block linear of
# width >= 32, int4 groups of 16 rows (32 for the UNets: their 32-wide
# inputs then take the ragged fallback to int8)
MIN_DIM, GROUP, UNET_GROUP = 32, 16, 32


def quant_env(monkeypatch, min_dim=MIN_DIM, group=GROUP):
    monkeypatch.setenv("SDXL_TPU_QUANT_MIN_DIM", str(min_dim))
    monkeypatch.setenv("SDXL_TPU_QUANT_GROUP", str(group))
    monkeypatch.setattr(tqz, "MIN_DIM", min_dim)
    monkeypatch.setattr(tqz, "GROUP", group)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same_state(module, want):
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def assert_same_quantized(module, want):
    """The quantized linears' tensors of ``module`` bitwise ``want``'s
    (the loaders' other tensors have tests of their own)."""
    keys = [k for k in want if k.endswith((".qw", ".qw4", ".qs"))]
    got = module.state_dict()
    assert keys and sorted(keys) == sorted(
        k for k in got if k.endswith((".qw", ".qw4", ".qs")))
    for k in keys:
        assert torch.equal(got[k], want[k]), k


def quantized_bits(module) -> dict:
    return {n: m.bits for n, m in module.named_modules()
            if isinstance(m, QuantLinear)}


def reference_bits(tree) -> dict:
    """{port module path: bits} of a quantized reference tree."""
    return {k.rpartition(".")[0]: 8 if k.endswith(".qw") else 4
            for k in tree_to_state_dict(tree) if k.endswith((".qw", ".qw4"))}


# ---------------------------------------------------------------------------
# the quantizers and the linear
# ---------------------------------------------------------------------------

def _weight(dtype, seed=0, shape=(128, 96)):
    """[d_in, d_out] f32 numpy weight (a zero column), in `dtype`'s values."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 5] = 0.0
    t = torch.from_numpy(w).to(dtype)
    return t.float().numpy(), t


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizers_and_dequant_match_reference(bits, dtype):
    """quantize_int8 / quantize_int4 bitwise the reference's on the same
    weight (its values in f32 and bf16), transposed; dequant_weight_plain
    bitwise dequant_weight in f32 and bf16."""
    w_ref, w = _weight(dtype)
    want = jq.quantize_weight(w_ref, bits, 16)
    got = tq.quantize_weight(w.t(), bits, 16)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == to_tensor(v).dtype
        np.testing.assert_array_equal(got[k].numpy(), v.T if v.ndim == 2
                                      else v, err_msg=k)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jq.dequant_weight(
            {k: jnp.asarray(v) for k, v in want.items()}, jd
        ).astype(jnp.float32))
        out = tq.dequant_weight_plain(got, td)
        assert out.dtype == td
        np.testing.assert_array_equal(out.float().numpy(), ref.T)


@pytest.mark.parametrize("bits", [8, 4])
def test_representable_weights_round_trip_exactly(bits):
    """tests/test_quant.py's representable weights: quantize, dequantize
    in f32, the same weight bit for bit."""
    from tests.test_quant import _representable_int4, _representable_int8

    rng = np.random.default_rng(3)
    w = (_representable_int8(rng, 64, 48) if bits == 8
         else _representable_int4(rng, 64, 48, 16))
    p = tq.quantize_weight(torch.from_numpy(w.T.copy()), bits, 16)
    np.testing.assert_array_equal(tq.dequant_weight_plain(p, F32).numpy(),
                                  w.T)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_linear_matches_reference_linear(bits, bias):
    """A QuantLinear holding the reference's quantized dict (through the
    bridge) against linear(p, x) on [2, 5, 128] f32 inputs: 1e-6
    relative."""
    rng = np.random.default_rng(bits + bias)
    w = rng.standard_normal((128, 96)).astype(np.float32) * 0.05
    p = jq.quantize_weight(w, bits, 16)
    if bias:
        p["b"] = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    want = np.asarray(j_linear({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x)))
    m = QuantLinear(128, 96, bits, bias=bias, group=16)
    m.load_state_dict(tree_to_state_dict(p))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got, want, LIN_TOL)


def test_quant_linear_refusals():
    """No gradient through K4 (QLoRA is module 15); K4's shape rule; a
    device with no kernel; a bad bits or spec, as the reference refuses
    them."""
    m = QuantLinear(64, 32, 8)
    m.qw.zero_()
    m.qs.fill_(1.0)
    x = torch.zeros(3, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="module 15"):
        m(x)
    with torch.no_grad():
        assert m(x).shape == (3, 32)
    assert tq.kernel_takes(3072, 18432, 8)
    assert tq.kernel_takes(15360, 3072, 4, 64)
    assert not tq.kernel_takes(3000, 3072, 8)
    assert not tq.kernel_takes(1280, 1284, 8)
    assert not tq.kernel_takes(1280, 1280, 4, 16)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tq.quant_linear(torch.zeros(2, 64, device="meta"), m.quantized)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tq.quantize_weight(torch.zeros(8, 8), 3)
    for spec in ("int3", "fp8"):
        with pytest.raises(ValueError) as want:
            jqz.parse_quantize_spec(spec)
        with pytest.raises(ValueError) as got:
            tqz.parse_quantize_spec(spec)
        assert str(got.value) == str(want.value)
    assert tqz.parse_quantize_spec("none") is None
    assert tq.is_quantized(m.quantized) and not tq.is_quantized({"w": 0})
    assert [tqz.parse_quantize_spec(s) for s in ("int8", "4")] == [8, 4]


# ---------------------------------------------------------------------------
# the module walk and the quantized forwards
# ---------------------------------------------------------------------------

def _unet_pair():
    unet = init_reference_(UNet(TINY_BASE.unet_config(), "cpu", F32),
                           torch.Generator().manual_seed(7))
    _moved(unet, seed=8)
    return fused(reference_tree(unet)), unet.eval().requires_grad_(False)


FAMILIES = {
    # family -> (reference tree and port model, rules)
    "unet": (_unet_pair, dict(within=jqz.UNET_WITHIN, keep8=jqz.UNET_KEEP8)),
    "mmdit": (lambda: (lambda t: (t, port_mmdit(t)))(numpy_tree(
        init_mmdit(jax.random.PRNGKey(0), _jcfg(MMDIT, jcfg.MMDiTConfig)),
        1)), {}),
    "flux": (lambda: (lambda t: (t, _port(Flux(FLUX, "cpu", F32),
                                          flux_state_dict(t))))(numpy_tree(
        init_flux(jax.random.PRNGKey(1), _jcfg(FLUX, jcfg.FluxConfig)), 2)),
        {}),
    "t5": (lambda: (lambda t: (t, port_t5(t)))(numpy_tree(
        init_t5(jax.random.PRNGKey(2), TINY_T5), 3)), {}),
}


def _port(module, sd):
    module.load_state_dict(sd)
    return module.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    return {name: make() for name, (make, _) in FAMILIES.items()}


# (family, bits, min_dim, group): the UNet's ragged 32-wide inputs and its
# lin_embed clamp at int4, T5 with min_dim 48 (its 32-wide attention
# linears left out) and group 32 (its 96-wide inputs ragged)
WALKS = [("unet", 8, MIN_DIM, UNET_GROUP), ("unet", 4, MIN_DIM, UNET_GROUP),
         ("mmdit", 8, MIN_DIM, GROUP), ("mmdit", 4, MIN_DIM, GROUP),
         ("flux", 8, MIN_DIM, GROUP), ("flux", 4, MIN_DIM, GROUP),
         ("t5", 8, MIN_DIM, GROUP), ("t5", 4, 48, 32)]


def _quantize_both(models, family, bits, min_dim, group):
    tree, model = models[family]
    rules = FAMILIES[family][1]
    with pytest.MonkeyPatch.context() as mp:
        quant_env(mp, min_dim, group)
        jtree = np_tree(jqz.quantize_tree(tree, bits, **rules))
        port = tqz.quantize_model(copy.deepcopy(model), bits, **rules)
    return jtree, port


@pytest.mark.parametrize("family,bits,min_dim,group", WALKS)
def test_module_walk_matches_quantize_tree(family, bits, min_dim, group,
                                           models):
    """quantize_model replaces the linears quantize_tree quantizes, at
    its bits, and every tensor of the result equals the reference tree's
    through the bridge."""
    jtree, port = _quantize_both(models, family, bits, min_dim, group)
    want_bits = reference_bits(jtree)
    assert want_bits and quantized_bits(port) == want_bits
    if bits == 4:
        assert {8, 4} <= set(want_bits.values())  # a clamp or a fallback
    if min_dim > MIN_DIM:
        assert any(isinstance(m, torch.nn.Linear) for m in port.modules())
    convert = {"unet": unet_state_dict, "mmdit": mmdit_state_dict,
               "flux": flux_state_dict, "t5": t5_state_dict}[family]
    assert_same_state(port, convert(jtree))


def _forward_inputs(family):
    rng = np.random.default_rng(11)
    if family == "unet":
        return (rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                np.array([937.5, 212.0], np.float32),
                rng.standard_normal((2, 7, 64)).astype(np.float32),
                rng.standard_normal((2, TINY_BASE.adm_in_channels)
                                    ).astype(np.float32))
    if family == "mmdit":
        return (rng.standard_normal((2, 8, 6, 16)).astype(np.float32),
                np.array([937.5, 212.25], np.float32),
                rng.standard_normal((2, 7, 96)).astype(np.float32),
                rng.standard_normal((2, 80)).astype(np.float32))
    if family == "flux":
        return (rng.standard_normal((2, 8, 6, 16)).astype(np.float32),
                np.array([937.5, 212.25], np.float32),
                rng.standard_normal((2, 7, 48)).astype(np.float32),
                rng.standard_normal((2, 32)).astype(np.float32),
                np.array([3500.0, 2500.0], np.float32))
    return (rng.integers(0, TINY_T5.vocab_size, (2, 9)).astype(np.int32),)


@pytest.mark.parametrize("family,bits", [("unet", 4), ("mmdit", 8),
                                         ("flux", 4), ("t5", 8)])
def test_quantized_forward_matches_reference(family, bits, models):
    """One forward of each quantized family against the reference's on
    the quantized tree: UNet 2e-3, MMDiT and FLUX.1 1e-3 of max|ref|, T5
    2e-4."""
    group = UNET_GROUP if family == "unet" else GROUP
    jtree, port = _quantize_both(models, family, bits, MIN_DIM, group)
    args = _forward_inputs(family)
    tj = [jnp.asarray(a) for a in args]
    tt = [torch.from_numpy(a) for a in args]
    if family == "unet":
        ucfg = TINY_BASE.unet_config()
        want = jax.jit(j_unet_forward, static_argnums=1)(jtree, ucfg, *tj)
        got, tol = unet_forward(port, *tt), UNET_TOL
    elif family == "mmdit":
        want = jax.jit(j_mmdit_forward, static_argnums=1)(
            jtree, _jcfg(MMDIT, jcfg.MMDiTConfig), *tj)
        got, tol = mmdit_forward(port, *tt), MODEL_TOL
    elif family == "flux":
        want = jax.jit(j_flux_forward, static_argnums=1)(
            jtree, _jcfg(FLUX, jcfg.FluxConfig), *tj[:4], guidance=tj[4])
        got, tol = flux_forward(port, *tt[:4], guidance=tt[4]), MODEL_TOL
    else:
        want = jax.jit(j_t5_encode, static_argnums=1)(jtree, TINY_T5, tj[0])
        got, tol = t5_encode(port, tt[0].long()), T5_TOL
    _close(got, want, tol)


def test_random_quantized_like_matches_reference_layout():
    """random_quantized_like on a meta-device FLUX.1: the quantized
    linears, their tensors' names, shapes and dtypes and their 0.02 / 127
    scales as the reference's random_quantized_like gives them (through
    the bridge), int8 values in [-127, 127]; nothing left on the meta
    device and no eligible linear with a full-precision weight."""
    jtree = np_tree(jqz.random_quantized_like(
        jax.random.PRNGKey(0), jax.eval_shape(
            lambda: init_flux(jax.random.PRNGKey(1),
                              _jcfg(FLUX, jcfg.FluxConfig))),
        8, MIN_DIM, GROUP))
    want = {k: v for k, v in flux_state_dict(jtree).items()
            if k.endswith((".qw", ".qw4", ".qs"))}
    port = tqz.random_quantized_like(Flux(FLUX, "meta", F32), 8,
                                     torch.Generator().manual_seed(0), "cpu",
                                     min_dim=MIN_DIM, group=GROUP)
    got = {k: v for k, v in port.state_dict().items()
           if k.endswith((".qw", ".qw4", ".qs"))}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert (got[k].shape, got[k].dtype) == (w.shape, w.dtype), k
        if k.endswith(".qs"):
            assert torch.equal(got[k], w), k
        else:
            assert -127 <= int(got[k].min()) and int(got[k].max()) <= 127
    assert not any(t.is_meta for t in (*port.parameters(), *port.buffers()))
    assert not any(hasattr(m, "weight") for m in port.modules()
                   if isinstance(m, QuantLinear))


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sdxl():
    """(reference, port) SDXL pipelines with the refiner on the same tiny
    weights, unquantized."""
    tpipe = random_pipeline(device="cpu", embedder_cfg=TINY_EMBEDDER,
                            diffuser_cfg=TINY_BASE, vae_cfg=TINY_VAE,
                            unet_dtype=F32, refiner_cfg=TINY_REFINER)
    _moved(tpipe.embedder, tpipe.unet, tpipe.refiner, tpipe.vae, seed=12)
    tpipe.strict_resolutions = False
    alphas = jnp.asarray(scaled_linear_alphas_cumprod())
    jpipe = JPipeline(
        embedder_cfg=TINY_EMBEDDER,
        embedder_params={k: reference_tree(tpipe.embedder[k])
                         for k in ("clip", "open_clip")},
        diffuser_cfg=TINY_BASE, unet_params=fused(reference_tree(tpipe.unet)),
        alphas_cumprod=alphas, vae_cfg=TINY_VAE,
        vae_params=reference_tree(tpipe.vae), refiner_cfg=TINY_REFINER,
        refiner_params=fused(reference_tree(tpipe.refiner)),
        refiner_alphas=alphas, clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32, strict_resolutions=False)
    return jpipe, tpipe


def reference_quantizes_on_host(monkeypatch):
    """The reference's quantize_tree through the host (numpy) branch of its
    quantize_weight, which its own tests hold bitwise to the device branch
    (tests/test_quant.py::test_device_quantize_matches_host): the same
    bits, without an eager XLA compile of each op at each linear's
    shape."""
    def on_host(w, bits, group=jq.INT4_GROUP):
        return {k: jnp.asarray(v) for k, v in jq.quantize_weight(
            np.asarray(w), bits, group).items()}

    monkeypatch.setattr(jqz, "quantize_weight", on_host)


def _quantized_unets(pair, bits, monkeypatch, group=UNET_GROUP):
    """The pair with the UNets' block linears quantized on both sides (the
    reference's on its host branch)."""
    jpipe, tpipe = pair
    quant_env(monkeypatch, MIN_DIM, group)
    reference_quantizes_on_host(monkeypatch)
    rules = dict(within=jqz.UNET_WITHIN, keep8=jqz.UNET_KEEP8)
    jkw = dict(unet_params=np_tree(jqz.quantize_tree(jpipe.unet_params, bits,
                                                     **rules)))
    tkw = dict(unet=copy.deepcopy(tpipe.unet))
    quantize_unet(tkw["unet"], bits)
    if getattr(tpipe, "refiner", None) is not None:
        jkw["refiner_params"] = np_tree(jqz.quantize_tree(
            jpipe.refiner_params, bits, **rules))
        tkw["refiner"] = copy.deepcopy(tpipe.refiner)
        quantize_unet(tkw["refiner"], bits)
    return (dataclasses.replace(jpipe, **jkw),
            dataclasses.replace(tpipe, **tkw))


def test_sdxl_int8_txt2img_with_refiner_matches_reference(sdxl, monkeypatch):
    """Base and refiner quantized at int8: txt2img, then the refiner's
    re-noise and tail, with the reference's draws injected."""
    jpipe, tpipe = _quantized_unets(sdxl, 8, monkeypatch)
    assert quantized_bits(tpipe.unet) and quantized_bits(tpipe.refiner)
    initial, _, renoise = reference_draws(5)
    kw = dict(resolution=RES, n_steps=STEPS, seed=5, negative_prompt=NEGATIVE,
              use_refiner=True)
    want_images, want_latent = run_reference(
        monkeypatch, jpipe, lambda: jpipe.txt2img(PROMPT, **kw))
    inject(monkeypatch, initial, None, renoise)
    got = tpipe.txt2img(PROMPT, **kw)
    assert_matches(got, tpipe.last_latent.numpy(), want_images, want_latent,
                   initial)


def test_sd2_int4_txt2img_matches_reference(monkeypatch):
    """SD 2.x v-prediction (its transformer in the middle block) with the
    UNet at int4 (lin_embed int8, the 32-wide inputs ragged): DDIM."""
    pair = _quantized_unets(sd1_pair(MID_V, CLIP_H, penultimate=True,
                                     seed=2), 4, monkeypatch)
    assert set(quantized_bits(pair[1].unet).values()) == {8, 4}
    sd1_txt2img(monkeypatch, pair, "sample_latent", seed=9)


@pytest.fixture(scope="module")
def sd3_trees():
    g = torch.Generator().manual_seed(4)
    from tests.test_sd3_loader import TINY_CLIP_G, TINY_CLIP_L, TINY_SD3_VAE
    from sdxl_tpu_torch.models.clip import CLIPTextModel
    from sdxl_tpu_torch.models.vae import VAEDecoder, VAEEncoder

    clip_l = init_reference_(CLIPTextModel(TINY_CLIP_L, "cpu"), g).eval()
    clip_g = init_reference_(CLIPTextModel(TINY_CLIP_G, "cpu"), g).eval()
    vae = init_reference_(VAEDecoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    enc = init_reference_(VAEEncoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    _moved(clip_l, clip_g, vae, enc, seed=5)
    return dict(
        mmdit=numpy_tree(init_mmdit(jax.random.PRNGKey(0),
                                    _jcfg(MMDIT, jcfg.MMDiTConfig)), 1),
        t5=numpy_tree(init_t5(jax.random.PRNGKey(2), TINY_T5), 3),
        clip_l=clip_l, clip_g=clip_g, vae=vae, enc=enc, cfgs=(TINY_CLIP_L,
                                                     TINY_CLIP_G,
                                                     TINY_SD3_VAE))


def test_sd3_int8_with_t5_matches_reference(sd3_trees, monkeypatch):
    """SD3 with the MMDiT and T5 at int8 (load_sd3_pipeline's recipe):
    txt2img with CFG."""
    t = sd3_trees
    quant_env(monkeypatch)
    mm = np_tree(jqz.quantize_tree(t["mmdit"], 8))
    t5 = np_tree(jqz.quantize_tree(t["t5"], 8))
    clip_l_cfg, clip_g_cfg, vae_cfg = t["cfgs"]
    jpipe = j_sd3.SD3Pipeline(
        mmdit_cfg=_jcfg(MMDIT, jcfg.MMDiTConfig), mmdit_params=mm,
        clip_l_cfg=clip_l_cfg, clip_l_params=reference_tree(t["clip_l"]),
        clip_g_cfg=clip_g_cfg, clip_g_params=reference_tree(t["clip_g"]),
        vae_cfg=vae_cfg, vae_params=reference_tree(t["vae"]),
        t5_cfg=TINY_T5, t5_params=t5, t5_tokenize=STUB_T5,
        clip_tokenizer=ClipTokenizer(None),
        open_clip_tokenizer=OpenClipTokenizer(None),
        compute_dtype=jnp.float32)
    from sdxl_tpu_torch.tokenizer import ClipTokenizer as TClip
    from sdxl_tpu_torch.tokenizer import OpenClipTokenizer as TOpenClip

    tpipe = t_sd3.SD3Pipeline(
        vae=t["vae"], vae_encoder=None, scale_factor=tcfg.SD3_VAE_SCALE,
        shift_factor=tcfg.SD3_VAE_SHIFT,
        mmdit=tqz.quantize_model(port_mmdit(t["mmdit"]), 8),
        clip_l=t["clip_l"], clip_g=t["clip_g"],
        t5=tqz.quantize_model(port_t5(t["t5"]), 8), t5_tokenize=STUB_T5,
        clip_tokenizer=TClip(), open_clip_tokenizer=TOpenClip())
    assert quantized_bits(tpipe.t5) == reference_bits(t5)
    assert_request(*run_pair(monkeypatch, (jpipe, tpipe), "txt2img", PROMPT,
                             resolution=RES, n_steps=3, guidance_scale=5.0,
                             seed=3, negative_prompt=NEGATIVE))


@pytest.fixture(scope="module")
def flux_trees():
    from sdxl_tpu_torch.models.clip import CLIPTextModel
    from sdxl_tpu_torch.models.vae import VAEDecoder, VAEEncoder
    from tests.test_sd3_loader import TINY_SD3_VAE

    g = torch.Generator().manual_seed(21)
    clip = init_reference_(CLIPTextModel(FLUX_CLIP_L, "cpu"), g).eval()
    vae = init_reference_(VAEDecoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    enc = init_reference_(VAEEncoder(TINY_SD3_VAE, "cpu"), g, 0.05).eval()
    _moved(clip, vae, enc, seed=22)
    return dict(
        dev=numpy_tree(init_flux(jax.random.PRNGKey(0),
                                 _jcfg(FLUX, jcfg.FluxConfig)), 1),
        t5=numpy_tree(init_t5(jax.random.PRNGKey(2), FLUX_JT5), 3),
        clip=clip, vae=vae, enc=enc)


def test_flux_int4_matches_reference(flux_trees, monkeypatch):
    """FLUX.1-dev with the transformer at int4 (its mods int8) and T5 at
    int8 (load_flux_pipeline's recipe): txt2img."""
    quant_env(monkeypatch)
    jpipe, tpipe = flux_pair(flux_trees, "dev")
    jpipe = dataclasses.replace(
        jpipe, flux_params=np_tree(jqz.quantize_tree(flux_trees["dev"], 4)),
        t5_params=np_tree(jqz.quantize_tree(flux_trees["t5"], 8)))
    tqz.quantize_model(tpipe.flux, 4)
    tqz.quantize_model(tpipe.t5, 8)
    assert set(quantized_bits(tpipe.flux).values()) == {8, 4}
    assert_request(*flux_run_pair(monkeypatch, (jpipe, tpipe), "txt2img", PROMPT,
                             resolution=RES, n_steps=3, guidance_scale=3.5,
                             seed=3))


def test_t5_offload_conditioning_matches_resident(flux_trees):
    """t5_offload: the conditioning bitwise the resident one's, and T5
    still parked on the host after the call (the reference's
    test_t5_offload_conditioning_matches_resident)."""
    _, tpipe = flux_pair(flux_trees, "dev")
    tqz.quantize_model(tpipe.t5, 8, min_dim=MIN_DIM)
    ctx_a, pooled_a = tpipe.conditioning(["a crab"])
    tpipe.t5_offload = True
    ctx_b, pooled_b = tpipe.conditioning(["a crab"])
    assert torch.equal(ctx_a, ctx_b) and torch.equal(pooled_a, pooled_b)
    assert all(t.device.type == "cpu"
               for t in (*tpipe.t5.parameters(), *tpipe.t5.buffers()))


# ---------------------------------------------------------------------------
# the loaders, with a LoRA merged before the quantizer
# ---------------------------------------------------------------------------

def _lora_file(path, mods, prefix, suffix, seed):
    rng = np.random.default_rng(seed)
    t = {}
    for name, (d_in, d_out) in mods.items():
        t[f"{prefix}{name}{suffix[0]}"] = rng.standard_normal(
            (4, d_in)).astype(np.float32)
        t[f"{prefix}{name}{suffix[1]}"] = rng.standard_normal(
            (d_out, 4)).astype(np.float32) * 0.1
    st_save(t, path)
    return [(path, 0.7)]


@pytest.fixture(scope="module")
def sdxl_ckpt(sdxl, tmp_path_factory):
    _, tpipe = sdxl
    return save_native_pipeline(
        str(tmp_path_factory.mktemp("q") / "ckpt"), tpipe)


def test_load_pipeline_quantizes_after_lora(sdxl, sdxl_ckpt, tmp_path,
                                            monkeypatch):
    """load_pipeline(use_refiner, loras, quantize="int4") against the
    reference's on the port-written native checkpoint (its quantizer on
    its host branch): the quantized linears of the base UNet (a LoRA on a
    self-attention q and a GEGLU projection merged in full precision, then
    quantized) and of the refiner bitwise."""
    quant_env(monkeypatch, MIN_DIM, UNET_GROUP)
    reference_quantizes_on_host(monkeypatch)
    loras = _lora_file(
        str(tmp_path / "lora.safetensors"),
        {"input_blocks_1_1_transformer_blocks_0_attn1_to_q": (32, 32),
         "input_blocks_2_1_transformer_blocks_0_ff_net_0_proj": (32, 256)},
        "lora_unet_", (".lora_down.weight", ".lora_up.weight"), 13)
    want = j_loader.load_pipeline(sdxl_ckpt, True, jnp.float32,
                                  stack_transformers=False, loras=loras,
                                  quantize="int4")
    got = load_pipeline(sdxl_ckpt, True, F32, loras=loras, quantize="int4",
                        device="cpu")
    assert_same_quantized(got.unet, unet_state_dict(np_tree(
        want.unet_params)))
    assert_same_quantized(got.refiner, unet_state_dict(np_tree(
        want.refiner_params)))
    plain = _quantized_unets(sdxl, 4, monkeypatch)[1].unet.state_dict()
    moved = [k for k, v in got.unet.state_dict().items()
             if not torch.equal(v, plain[k])]
    assert len(moved) == 4  # the two linears' quantized bytes and scales


@pytest.fixture(scope="module")
def diffusers_dirs(flux_trees, sd3_trees, tmp_path_factory):
    """Tiny diffusers directories of the SD3 trees (with T5) and the
    FLUX.1-dev trees, and a transformer LoRA file for each:
    {"sd3": (dir, loras), "flux": (dir, loras)}."""
    from tests.test_diffusers_sdxl import make_diffusers_vae_dict
    from tests.test_flux_loader import make_diffusers_flux_dict
    from tests.test_sd3_loader import _make_hf_clip_dict

    root = tmp_path_factory.mktemp("dirs")

    def write(root, sub, d, config):
        os.makedirs(root / sub)
        st_save({k: np.ascontiguousarray(v, np.float32)
                 for k, v in d.items()},
                str(root / sub / "diffusion_pytorch_model.safetensors"))
        with open(root / sub / "config.json", "w") as f:
            json.dump(config, f)

    t5_config = {"d_kv": 8, "num_heads": 4,
                 "relative_attention_num_buckets": 8,
                 "relative_attention_max_distance": 16}
    s, f = sd3_trees, flux_trees
    sd3 = root / "sd3"
    write(sd3, "transformer", make_diffusers_mmdit_dict(MMDIT, s["mmdit"]),
          {"attention_head_dim": 8, "num_attention_heads": 4,
           "pos_embed_max_size": 16, "num_layers": 3,
           "dual_attention_layers": [1]})
    for sub, model, cfg in (("text_encoder", s["clip_l"], s["cfgs"][0]),
                            ("text_encoder_2", s["clip_g"], s["cfgs"][1])):
        write(sd3, sub, _make_hf_clip_dict(cfg, reference_tree(model)),
              {"hidden_size": cfg.n_state, "projection_dim": cfg.embed_dim,
               "num_attention_heads": cfg.n_head,
               "num_hidden_layers": cfg.n_layer,
               "hidden_act": "quick_gelu" if cfg.quick_gelu else "gelu"})
    write(sd3, "text_encoder_3", make_hf_t5_dict(TINY_T5, s["t5"]),
          t5_config)
    write(sd3, "vae", make_diffusers_vae_dict(reference_tree(s["vae"],
                                                             s["enc"])),
          {"norm_num_groups": 4})
    h = MMDIT.hidden
    sd3_loras = _lora_file(str(root / "sd3_lora.safetensors"),
                           {"transformer_blocks.0.attn.to_q": (h, h),
                            "transformer_blocks.1.ff.net.0.proj": (h, 4 * h)},
                           "transformer.", (".lora_A.weight",
                                            ".lora_B.weight"), 14)

    flux = root / "flux"
    write(flux, "transformer", make_diffusers_flux_dict(FLUX, f["dev"]),
          {"attention_head_dim": 16, "num_attention_heads": 2,
           "axes_dims_rope": [4, 6, 6]})
    write(flux, "text_encoder", _make_hf_clip_dict(
        FLUX_CLIP_L, reference_tree(f["clip"])),
        {"hidden_size": 32, "num_attention_heads": 4,
         "num_hidden_layers": 2, "hidden_act": "quick_gelu"})
    write(flux, "text_encoder_2", make_hf_t5_dict(FLUX_JT5, f["t5"]),
          t5_config)
    vd = make_diffusers_vae_dict(reference_tree(f["vae"], f["enc"]))
    write(flux, "vae", {k: v for k, v in vd.items() if "quant_conv" not in k},
          {"norm_num_groups": 4})
    h = FLUX.hidden
    flux_loras = _lora_file(str(root / "flux_lora.safetensors"),
                            {"transformer_blocks.0.attn.to_q": (h, h),
                             "single_transformer_blocks.1.proj_mlp":
                                 (h, 4 * h)},
                            "transformer.", (".lora_A.weight",
                                             ".lora_B.weight"), 15)
    return {"sd3": (str(sd3), sd3_loras), "flux": (str(flux), flux_loras)}


def test_load_sd3_and_flux_pipelines_quantize_after_lora(diffusers_dirs,
                                                         monkeypatch):
    """load_sd3_pipeline and load_flux_pipeline with a transformer LoRA
    and quantize="int8" / "int4": the transformer and T5 (int8) bitwise
    as the reference's loaders leave them."""
    quant_env(monkeypatch)
    sd3, loras = diffusers_dirs["sd3"]
    want = j_sd3.load_sd3_pipeline(sd3, jnp.float32, t5_tokenize=STUB_T5,
                                   loras=loras, quantize="int4")
    got = t_sd3.load_sd3_pipeline(sd3, F32, t5_tokenize=STUB_T5,
                                  loras=loras, quantize="int4", device="cpu")
    assert_same_quantized(got.mmdit, mmdit_state_dict(np_tree(
        want.mmdit_params)))
    assert_same_quantized(got.t5, t5_state_dict(np_tree(want.t5_params)))
    assert set(quantized_bits(got.t5).values()) == {8}

    flux, loras = diffusers_dirs["flux"]
    want = j_flux.load_flux_pipeline(flux, jnp.float32,
                                     t5_tokenize=FLUX_STUB_T5, loras=loras,
                                     quantize="int8")
    got = t_flux.load_flux_pipeline(flux, F32, t5_tokenize=FLUX_STUB_T5,
                                    loras=loras, quantize="int8",
                                    device="cpu")
    assert_same_quantized(got.flux, flux_state_dict(np_tree(
        want.flux_params)))
    assert_same_quantized(got.t5, t5_state_dict(np_tree(want.t5_params)))
    assert got.t5_offload is want.t5_offload is False


def _load(family, dirs, device="cpu", **kw):
    path, loras = dirs[family]
    if family == "sd3":
        return t_sd3.load_sd3_pipeline(path, F32, t5_tokenize=STUB_T5,
                                       loras=loras, device=device, **kw)
    return t_flux.load_flux_pipeline(path, F32, t5_tokenize=FLUX_STUB_T5,
                                     loras=loras, device=device, **kw)


@pytest.mark.parametrize("family,bits", [("sd3", 4), ("flux", 8)])
def test_quantized_loads_stage_each_linear_alone(family, bits,
                                                 diffusers_dirs,
                                                 monkeypatch):
    """A quantizing load builds the transformer and T5 on the host
    (towers_device "cpu", where the unquantized load builds them on its
    device; the target here is "cpu:0", the host under another name),
    stages each eligible linear's weight on the target device alone
    (every earlier staged weight freed before the next is staged), and
    leaves the quantized buffers bitwise those of the unquantized load
    quantized afterwards by quantize_model, as the loaders did before
    they staged."""
    import weakref

    import sdxl_tpu_torch.io.flux as io_flux
    import sdxl_tpu_torch.io.sd3 as io_sd3

    quant_env(monkeypatch)
    io_mod = io_sd3 if family == "sd3" else io_flux
    reader = ("load_sd3_diffusers_dir" if family == "sd3"
              else "load_flux_diffusers_dir")
    real_read, real_stage = getattr(io_mod, reader), tqz._stage
    read_devices, staged = [], []

    def read(*args, **kw):
        read_devices.append(str(kw["towers_device"]))
        return real_read(*args, **kw)

    def stage(w, device):
        assert all(ref() is None for ref in staged), "two weights staged"
        assert str(device) == "cpu:0"
        out = real_stage(w, device).clone()  # a copy, as on the card
        staged.append(weakref.ref(out))
        return out

    monkeypatch.setattr(io_mod, reader, read)
    monkeypatch.setattr(tqz, "_stage", stage)
    got = _load(family, diffusers_dirs, "cpu:0", quantize=f"int{bits}")
    plain = _load(family, diffusers_dirs, "cpu:0")
    assert read_devices == ["cpu", "cpu:0"]
    model = plain.mmdit if family == "sd3" else plain.flux
    n_linears = (len(tqz.eligible_linears(model, bits))
                 + len(tqz.eligible_linears(plain.t5, 8)))
    assert len(staged) == n_linears > 0
    assert all(ref() is None for ref in staged)
    want = {"model": tqz.quantize_model(model, bits).state_dict(),
            "t5": tqz.quantize_model(plain.t5, 8).state_dict()}
    assert_same_quantized(got.mmdit if family == "sd3" else got.flux,
                          want["model"])
    assert_same_quantized(got.t5, want["t5"])


def test_t5_offload_is_decided_before_t5_moves(diffusers_dirs,
                                               monkeypatch):
    """load_flux_pipeline over its budget: the decision sees T5 still on
    the host and unquantized, and a need counted from the quantized
    transformer and T5's quantized bytes (quantized_bytes: what
    param_bytes gives after quantize_model); T5 is then quantized where it
    is (only the transformer's linears staged) and stays on the host,
    bitwise the in-budget load's T5."""
    import sdxl_tpu_torch.io.flux as io_flux
    from sdxl_tpu_torch.utils.memory import param_bytes

    quant_env(monkeypatch)
    t5, seen, staged = [], [], []
    real_read, real_stage = io_flux.load_flux_diffusers_dir, tqz._stage

    def read(*args, **kw):
        out = real_read(*args, **kw)
        t5.append(out[2])
        return out

    def over_budget(need, device):
        seen.append((need, {p.device.type for p in t5[-1].parameters()},
                     any(isinstance(m, QuantLinear)
                         for m in t5[-1].modules())))
        return need - 1  # a budget the towers pass

    def stage(w, device):
        staged.append(tuple(w.shape))
        return real_stage(w, device)

    monkeypatch.setattr(io_flux, "load_flux_diffusers_dir", read)
    monkeypatch.setattr(t_flux, "_over_budget", over_budget)
    monkeypatch.setattr(tqz, "_stage", stage)
    got = _load("flux", diffusers_dirs, quantize="int8")
    (need, t5_devices, t5_quantized), = seen
    assert t5_devices == {"cpu"} and not t5_quantized and got.t5_offload
    assert need == sum(param_bytes(m) for m in (got.flux, got.t5, got.clip,
                                                got.vae, got.vae_encoder))
    assert len(staged) == sum(isinstance(m, QuantLinear)
                              for m in got.flux.modules())
    monkeypatch.setattr(t_flux, "_over_budget", lambda need, device: None)
    resident = _load("flux", diffusers_dirs, quantize="int8")
    assert not resident.t5_offload
    assert_same_quantized(got.t5, resident.t5.state_dict())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(argv, out):
    from sdxl_tpu_torch.cli.sample import main

    assert main([*argv, "--f32", "--no-strict-resolution", "--prompt",
                 PROMPT, "--height", "64", "--width", "64", "-steps", "2",
                 "--seed", "3", "--negative-prompt", NEGATIVE,
                 "--output-dir", out], device="cpu") == 0
    return load_images([f"{out}0.png"])


def test_cli_quantize_matches_the_in_memory_pipeline(sdxl, sdxl_ckpt,
                                                     tmp_path, monkeypatch):
    """--quantize int8 on the random SDXL path (its presets patched to the
    tiny configs) and from the native checkpoint with --use-refiner:
    pixel for pixel the in-memory pipeline quantized the same way."""
    quant_env(monkeypatch, MIN_DIM, UNET_GROUP)
    real = tpipeline.random_pipeline
    tiny = dict(embedder_cfg=TINY_EMBEDDER, diffuser_cfg=TINY_BASE,
                vae_cfg=TINY_VAE)
    monkeypatch.setattr(tpipeline, "random_pipeline",
                        lambda **kw: real(**{**kw, **tiny}))
    got = _cli(["--random-weights", "--quantize", "int8"],
               str(tmp_path / "r"))
    pipe = real(device="cpu", unet_dtype=F32, with_encoder=True, **tiny)
    pipe.strict_resolutions = False
    quantize_unet(pipe.unet, 8)
    kw = dict(n_steps=2, seed=3, negative_prompt=NEGATIVE)
    np.testing.assert_array_equal(got, pipe.txt2img([PROMPT], RES, **kw))

    got = _cli(["--model-dir", sdxl_ckpt, "--quantize", "int8",
                "--use-refiner"], str(tmp_path / "c"))
    _, tpipe = _quantized_unets(sdxl, 8, monkeypatch)
    np.testing.assert_array_equal(
        got, tpipe.txt2img([PROMPT], RES, use_refiner=True, **kw))


def test_cli_bad_quantize_value_fails_as_the_reference(tmp_path, capsys):
    """--quantize int3: the reference's argparse choices refusal (exit 2,
    the same message), before any weights load."""
    from sdxl_tpu.cli.sample import main as j_main
    from sdxl_tpu_torch.cli.sample import main

    argv = ["--random-weights", "--prompt", "a cat", "--quantize", "int3",
            "--output-dir", str(tmp_path / "x")]
    with pytest.raises(SystemExit) as want:
        j_main(argv)
    want_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        main(argv, device="cpu")
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split(": ", 1)[1] == want_err.split(": ", 1)[1]
    assert not os.path.exists(tmp_path / "x0.png")


# ---------------------------------------------------------------------------
# full width: K4's shapes, the quantized bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, 8),
                                        (torch.bfloat16, 4), (F32, 8),
                                        (F32, 4)])
def test_k4_form_routes_by_rows(dtype, bits):
    """k4_form on both sides of GEMV_MAX_M: bf16 takes the GEMV up to it
    and the GEMM above, f32 its one form; every route is an exported
    kernel with a launch count. For the bf16 GEMM, k4_gemm_plan at the
    paths' shapes: a tile of 128 or 256 rows, a K split only where the
    output has fewer tiles than SMs, and no empty split."""
    gemv_max = tq.GEMV_MAX_M
    for m in (1, 2, gemv_max, gemv_max + 1, 16, 17, 154, 4608):
        want = "gemv" if dtype == torch.bfloat16 and m <= gemv_max else "gemm"
        assert tq.k4_form(m, dtype, bits) == want, m
        assert tq.k4_route(m, dtype, bits) == tq.ROUTES[dtype, bits, want]
    assert set(tq.launch_counts) == set(tq.ROUTES.values())
    if dtype != torch.bfloat16:
        return
    for m, k, n in ((4608, 15360, 3072), (4096, 3072, 12288), (512, 3072,
                    3072), (154, 2048, 1280), (17, 3072, 18432),
                    (gemv_max + 1, 1280, 1280), (333, 3072, 3072)):
        nt, splits = tq.k4_gemm_plan(m, n, k, bits)
        stages = -(-(k if bits == 8 else k // 2) // tq.GEMM_BK)
        tiles = -(-n // tq.GEMM_CHANNELS) * -(-m // nt)
        per = -(-stages // splits)
        assert nt in tq.GEMM_TILES and 1 <= splits <= tq.GEMM_MAX_SPLITS
        assert -(-stages // per) == splits
        assert splits == 1 or tiles < tq.H100_SMS, (m, k, n)


def _sd35(mod):
    """SD3.5-large's and -medium's published transformer configs."""
    large = dict(num_layers=38, n_heads=38, head_dim=64, qk_norm="rms")
    medium = dict(num_layers=24, n_heads=24, head_dim=64, qk_norm="rms",
                  pos_embed_max_size=384, dual_attention_layers=tuple(
                      range(13)))
    return mod.MMDiTConfig(**large), mod.MMDiTConfig(**medium)


def _full_width():
    """(label, port model on the meta device, the reference's abstract
    tree, rules) of every configuration the loaders quantize."""
    key = jax.random.PRNGKey(0)
    unet = dict(within=jqz.UNET_WITHIN, keep8=jqz.UNET_KEEP8)
    out = [(name, lambda c=getattr(tcfg, name): Flux(c, "meta"),
            lambda c=getattr(jcfg, name): init_flux(key, c, jnp.bfloat16),
            {}) for name in ("FLUX_DEV", "FLUX_SCHNELL")]
    for label, tc, jc in zip(("SD3-medium", "SD3.5-large", "SD3.5-medium"),
                             (tcfg.SD3_MEDIUM_MMDIT, *_sd35(tcfg)),
                             (jcfg.SD3_MEDIUM_MMDIT, *_sd35(jcfg))):
        out.append((label, lambda c=tc: MMDiT(c, "meta"),
                    lambda c=jc: init_mmdit(key, c), {}))
    out.append(("T5-XXL", lambda: T5Encoder(tcfg.T5_XXL_CONFIG, "meta"),
                lambda: init_t5(key, jcfg.T5_XXL_CONFIG), {}))
    for name in ("SDXL_BASE_DIFFUSER", "SDXL_REFINER_DIFFUSER",
                 "SD15_DIFFUSER", "SD2_DIFFUSER"):
        out.append((name, lambda c=getattr(tcfg, name): UNet(
            c.unet_config(), "meta", torch.bfloat16),
            lambda c=getattr(jcfg, name): fuse_unet_qkv(init_unet(
                key, c.unet_config(), jnp.bfloat16)), unet))
    return out


def _nbytes(a) -> int:
    return int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize


def test_k4_accepts_every_full_width_linear():
    """Each full-width configuration built on the meta device and
    quantized at int8 and int4 by quantize_model: K4's shape check takes
    every (d_in, d_out, bits) it makes, and the count and the bytes of the
    quantized weights and scales equal the reference's quantize_tree on
    the jax.eval_shape tree of the same configuration."""
    for label, make_port, make_ref, rules in _full_width():
        abstract = jax.eval_shape(make_ref)
        for bits in (8, 4):
            port = tqz.quantize_model(make_port(), bits, **rules)
            q = [m for m in port.modules() if isinstance(m, QuantLinear)]
            refused = sorted({(m.in_features, m.out_features, m.bits)
                              for m in q if not tq.kernel_takes(
                                  m.in_features, m.out_features, m.bits,
                                  tqz.GROUP)})
            assert q and not refused, (label, bits, refused)
            ref = jqz.quantize_tree(abstract, bits, **rules)
            leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
            ref_q = [(p, a) for p, a in leaves
                     if getattr(p[-1], "key", None) in ("qw", "qw4", "qs")]
            got = sum(b.numel() * b.element_size() for m in q
                      for b in m.buffers())
            assert (len(q), got) == (
                sum(getattr(p[-1], "key") in ("qw", "qw4") for p, _ in ref_q),
                sum(_nbytes(a) for _, a in ref_q)), (label, bits)
