"""The port's flash-attention experiments (sdxl_tpu_torch/scripts/) and
K1's new routes, through their plain versions on the CPU, against the
reference scripts' functions.

Each reference script (scripts/exp_flash_exp2.py, exp_flash_floor.py,
exp_flash_pipelined.py, bench_flash_ragged.py) is loaded by path, and its
module-level ``pl`` is replaced by a shim whose ``pallas_call`` runs in
interpret mode without the TPU compiler params; nothing under scripts/
changes. Inputs [1, 2, 256, 64] from numpy, reference blocks of 128.

Tolerances: f32 2e-5 (online vs one-shot softmax reorders the f32 sums);
bf16 2e-2, the kernels' on-device bound (bench.py:53-66), since the plain
versions round the normalised p where the kernels round the unnormalised
one; noexp is NaN everywhere in both (m starts at -inf), so it is compared
by its NaNs.
"""

import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdxl_tpu.ops.flash_attention import flash_attention_bhtd as j_flash
from sdxl_tpu_torch.ops import flash_attention as fa
from sdxl_tpu_torch.scripts import bench_flash_ragged
from sdxl_tpu_torch.scripts import exp_flash_exp2 as x1
from sdxl_tpu_torch.scripts import exp_flash_floor as x2
from sdxl_tpu_torch.scripts import exp_flash_pipelined as x3
from sdxl_tpu_torch.scripts import probe_bwd_kernels, probe_f32_kernels, timing

# One intra-op thread: the suite runs six workers on shared cores,
# where torch's default of a thread per core makes small ops spin.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SHAPE, BLOCK = (1, 2, 256, 64), 128


class _InterpretPallas:
    """The reference scripts' ``pl``, with pallas_call in interpret mode
    and without the TPU compiler params."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, compiler_params=None, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def ref():
    mods = {}
    for name in ("exp_flash_exp2", "exp_flash_floor", "exp_flash_pipelined",
                 "bench_flash_ragged"):
        spec = importlib.util.spec_from_file_location(
            f"_reference_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.pl = _InterpretPallas()
        mods[name] = mod
    return mods


def arrays(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def both(a, dtype=torch.float32):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return [jnp.asarray(x, jd) for x in a], [torch.from_numpy(x).to(dtype)
                                            for x in a]


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash2_plain_matches_reference(ref, dtype, tol):
    (jq, jk, jv), (q, k, v) = both(arrays(), dtype)
    want = ref["exp_flash_exp2"].flash2(jq, jk, jv, BLOCK, BLOCK)
    got = x1.flash2(q, k, v, BLOCK, BLOCK)
    assert got.dtype == dtype
    close(got, want, tol)


@pytest.mark.parametrize("mode", x2.MODES)
def test_attn_plain_matches_reference(ref, mode):
    (jq, jk, jv), (q, k, v) = both(arrays(seed=1))
    want = np.asarray(ref["exp_flash_floor"].attn(jq, jk, jv, mode, BLOCK,
                                                  BLOCK))
    got = x2.attn(q, k, v, mode, BLOCK, BLOCK).numpy()
    if mode == "noexp":
        assert np.isnan(want).all() and np.isnan(got).all()
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_flash_pipelined_plain_matches_reference(ref):
    (jq, jk, jv), (q, k, v) = both(arrays(seed=2))
    want = ref["exp_flash_pipelined"].flash_pipelined(jq, jk, jv, BLOCK,
                                                      BLOCK)
    close(x3.flash_pipelined(q, k, v, BLOCK, BLOCK), want, 2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_plain_ref_matches_xla_ref(ref, dtype, tol):
    (jq, jk, jv), (q, k, v) = both(arrays((1, 2, 200, 64), seed=3), dtype)
    want = ref["bench_flash_ragged"].xla_ref(jq, jk, jv)
    got = bench_flash_ragged.plain_ref(q, k, v)
    assert got.dtype == dtype
    close(got, want, tol)


def test_bf16_d512_route_plain_matches_jax_kernel():
    """K1's new bf16 d=512 route (the bf16 VAE decode's mid-block
    attention) through its plain version, ragged, against the reference
    kernel in bf16."""
    (jq, jk, jv), (q, k, v) = both(arrays((1, 1, 140, 512), seed=4),
                                   torch.bfloat16)
    want = j_flash(jq, jk, jv, 32, 128)
    got = fa.flash_attention_bhtd(q, k, v)
    assert got.dtype == torch.bfloat16
    close(got, want, 2e-2)


def test_tiles_must_divide_t():
    q = torch.zeros((1, 1, 200, 64))
    for call in (lambda: x1.flash2(q, q, q, 64, 64),
                 lambda: x2.attn(q, q, q, "full", 64, 64),
                 lambda: x3.flash_pipelined(q, q, q, 64, 128)):
        with pytest.raises(ValueError, match="must divide T"):
            call()


def test_query_tile_may_run_past_t():
    """X1 and X2 run K1's kernel, which takes a query tile that runs past T
    (192 rows at T = 4096); a key tile that does not divide T, or Tq != Tk,
    still raises, and X3's kernel still needs both tiles to divide T."""
    t4096 = torch.empty((1, 1, 4096, 64), device="meta")
    x1.check_tile("flash2", t4096, t4096, *x1.K1_TILE)
    for call in (lambda: x1.check_tile("flash2", t4096, t4096, 192, 96),
                 lambda: x1.check_tile("flash2", t4096[:, :, :4032], t4096,
                                       192, 64),
                 lambda: x3.flash_pipelined(t4096, t4096, t4096, 192, 128)):
        with pytest.raises(ValueError, match="must divide T"):
            call()
    (q, k, v) = (torch.from_numpy(x) for x in arrays((1, 1, 256, 64), 5))
    got = x1.flash2(q, k, v, 192, 128)
    assert got.shape == q.shape
    close(got, x1.flash2_plain(q, k, v), 0)


def test_experiment_tiles():
    """X1's sweep holds K1's tile, where X2 runs; X3 has its own tiles."""
    assert x1.K1_TILE == (192, 128) and x1.K1_TILE in x1.TILES
    assert x2.TILE == x1.K1_TILE
    assert sorted(x1.TILES) == [(64 * nc, bk) for nc in (1, 2, 3)
                                for bk in (64, 128)]
    assert x3.TILES == ((64, 64), (64, 128), (128, 64), (128, 128))
    assert set(x3.TILES) < set(x1.TILES)


def test_x1_x2_instantiate_k1s_kernel():
    """The X1 and X2 exports and K1's and K2's launcher instantiate one
    kernel template, flash_fwd_wgmma.cuh's, at the tiles and modes their
    wrappers name; the experiments' source defines no kernel of its own."""
    header = (fa.CSRC / "flash_fwd_wgmma.cuh").read_text()
    hopper = (fa.CSRC / "flash_hopper.cu").read_text()
    exp = (fa.CSRC / "flash_experiments.cu").read_text()
    assert "flash_fwd_wgmma.cuh" in fa.HEADERS
    assert re.search(r"__global__[^;{]*\bflash_fwd_wgmma\(", header)
    for text in (hopper, exp):
        assert '#include "flash_fwd_wgmma.cuh"' in text
        assert not re.search(r"\bflash_fwd_wgmma\(", text)
    assert "__global__" not in exp
    assert re.search(r"launch_fwd_wgmma<D, kK1Consumers<D>, kK1Keys, LSE, "
                     r"kPrescaleQ>", hopper)
    nc = int(re.search(r"kK1Consumers = D == 64 \? (\d) :", hopper)[1])
    keys = int(re.search(r"kK1Keys = (\d+);", hopper)[1])
    assert (64 * nc, keys) == x1.K1_TILE
    assert re.search(r"return launch_fwd_wgmma<64, NC, BK, false, MODE>\(",
                     exp)
    exports = {m[0]: (64 * int(m[1]), int(m[2]), m[3]) for m in re.findall(
        r"SDXL_EXP_EXPORT\((sdxl_\w+), (\d), (\d+), (k\w+)\)", exp)}
    modes = {"full": "kFull", "qscaled": "kQScaled", "noexp": "kNoExp",
             "mxu_only": "kMxuOnly"}
    want = {f"sdxl_flash2_bf16_q{bq}_k{bk}": (bq, bk, "kFull")
            for bq, bk in x1.TILES}
    want.update({f"sdxl_flash_floor_{m}_bf16": (*x2.TILE, modes[m])
                 for m in x2.MODES})
    assert exports == want


def test_no_fallback_off_the_cpu():
    """Only CPU tensors take the plain versions; on any other device the
    wrappers launch a kernel or raise (here `meta`, which has none), and
    K1 raises for the head widths no SDXL path has."""
    q = torch.empty((1, 1, 256, 64), dtype=torch.bfloat16, device="meta")
    for call in (lambda: x1.flash2(q, q, q), lambda: x3.flash_pipelined(q, q, q),
                 *(lambda m=m: x2.attn(q, q, q, m) for m in x2.MODES)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    wide = torch.empty((1, 1, 4096, 256), device="meta")
    with pytest.raises(ValueError, match="no SDXL path"):
        fa.flash_attention_bhtd(wide, wide, wide)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.timeit(x1.flash2, *[torch.zeros(SHAPE)] * 3)


def test_every_wrapper_names_an_exported_kernel():
    """The C functions the wrappers launch are registered (so counted) and
    exported by the source they are registered under."""
    names = {f"sdxl_flash2_bf16_q{bq}_k{bk}" for bq, bk in x1.TILES}
    names |= {f"sdxl_flash_floor_{m}_bf16" for m in x2.MODES}
    names |= {f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}" for bq, bk in x3.TILES}
    names |= set(fa._ROUTES.values())
    assert names <= set(fa._KERNELS) == set(fa.launch_counts)
    exported = {}
    for src in fa.SOURCES:
        text = (fa.CSRC / src).read_text()
        for name in re.findall(r'(?:extern "C" int|_EXPORT\()\s*(sdxl_\w+)',
                               text):
            exported[name] = src
    assert {n: s for n, (s, _, _) in fa._KERNELS.items()} == exported


def test_f32_kernel_probe_edits_the_kernels_it_names():
    """Each variant of scripts/probe_f32_kernels.py finds the text it edits
    in csrc/flash_hopper.cu once (it raises otherwise) and changes it."""
    base = (fa.CSRC / "flash_hopper.cu").read_text()
    sources = probe_f32_kernels.variant_sources()
    assert set(sources) == set(probe_f32_kernels.VARIANTS)
    assert all(text != base for text in sources.values())


def test_bwd_kernel_probe_edits_the_kernels_it_names():
    """Each variant of scripts/probe_bwd_kernels.py finds the text it edits
    in csrc/flash_hopper_bwd.cu once (it raises otherwise) and changes it."""
    base = (fa.CSRC / probe_bwd_kernels.SOURCE).read_text()
    sources = probe_f32_kernels.variant_sources(probe_bwd_kernels.SOURCE,
                                                probe_bwd_kernels.VARIANTS)
    assert set(sources) == set(probe_bwd_kernels.VARIANTS)
    assert all(text != base for text in sources.values())
