"""Design probes of the f32 flash kernels in csrc/flash_hopper.cu, on the
card: each variant is the source with one edit, built into its own library
beside the kernels' and timed in turns against the kernel as it is.

  k2_nc2      K2 f32 d=64 (`flash_fwd_tf32<true>`) with two consumer
              warpgroups (128-row tiles) in place of three, at the
              training path's batch-1 shapes;
  d512_pass1  K1 f32 d=512 (`flash_fwd_f32_d512`) with one TF32 pass of
              each product in place of three (its error printed);
  d512_no_s   the same kernel without the products of S (the operands
              still loaded and split);
  d512_no_pv  the same kernel without the products of P V.

base - d512_pass1 is the cost of two thirds of the tensor-core products,
base - d512_no_s and base - d512_no_pv what each product adds on top of
the rest of the kernel (loads, splits, the partial-S reduction, the
softmax, the barriers).

Run on the card: python -m sdxl_tpu_torch.scripts.probe_f32_kernels
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess

import torch

from ..ops import flash_attention as fa
from .exp_flash_exp2 import require_card
from .timing import timeit

_S_PRODUCTS = """\
            mma_tf32(sp[mt][nt], al[mt], bh0, bh1);
            mma_tf32(sp[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(sp[mt][nt], ah[mt], bh0, bh1);"""
_PV_PRODUCTS = """\
            mma_tf32(pv[mt], pl[ks][mt], bh0, bh1);
            mma_tf32(pv[mt], ph[ks][mt], bl0, bl1);
            mma_tf32(pv[mt], ph[ks][mt], bh0, bh1);"""
_TF32_CONSUMERS = """\
struct Tf32Plan {
  static constexpr int kNC = 3;"""
_TF32_REGISTERS = """\
  setmaxnreg_inc<160>();
  const int c = wg - 1;  // this warpgroup's rows: 64c .. 64c + 63
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tg = lane % 4;
  const uint32_t qhi_addr"""

# variant -> [(text of flash_hopper.cu, its replacement)]; a product left
# out still reads its operands, so that the compiler keeps their loads
VARIANTS = {
    "k2_nc2": [(_TF32_CONSUMERS, _TF32_CONSUMERS.replace("3;", "2;")),
               (_TF32_REGISTERS, _TF32_REGISTERS.replace("160", "232"))],
    "d512_pass1": [
        (_S_PRODUCTS, "            mma_tf32(sp[mt][nt], ah[mt], bh0, bh1);"),
        (_PV_PRODUCTS, "            mma_tf32(pv[mt], ph[ks][mt], bh0, bh1);")],
    "d512_no_s": [(_S_PRODUCTS, "            sp[mt][nt][0] += "
                   "__uint_as_float(ah[mt][0] ^ al[mt][1] ^ bh0 ^ bl1);")],
    "d512_no_pv": [(_PV_PRODUCTS, "            pv[mt][0] += __uint_as_float("
                    "ph[ks][mt][0] ^ pl[ks][mt][1] ^ bh0 ^ bl1);")],
}
K2_SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64)]
D512_SHAPE = (1, 1, 16384, 512)


def variant_sources() -> dict:
    """{variant: flash_hopper.cu with the variant's edits}."""
    src = (fa.CSRC / "flash_hopper.cu").read_text()
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edited text is not in "
                                   f"flash_hopper.cu once")
            text = text.replace(old, new)
        sources[name] = text
    return sources


def build_variants() -> dict:
    """{variant: its library}, one nvcc per variant, all started together,
    into build/kernels/probe/."""
    out = fa.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, text in variant_sources().items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *fa.NVCC_FLAGS, "-I", str(fa.CSRC),
             "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def _export(lib, name: str, n_ptr: int):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def variant_k2(lib, q, k, v):
    """K2 f32 d=64 (o, lse) from a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    scratch = fa._tf32_scratch(b * h, t, q.device)
    err = _export(lib, "sdxl_flash_attention_lse_f32_d64", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), b * h, t, t, d,
        d ** -0.5 * fa._LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o, lse


def variant_d512(lib, q, k, v):
    """K1 f32 d=512 from a variant's library."""
    b, h, t, d = q.shape
    o = torch.empty_like(q)
    err = _export(lib, "sdxl_flash_attention_f32_d512", 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, t, t,
        d, d ** -0.5 * fa._LOG2E, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return o


def _in_turns(fns: dict, iters: int) -> dict:
    """ms per call of each function, timed in turns (a, b, ..., b, a)."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(timeit(fns[name], iters=iters) * 1e3)
    return times


def main() -> dict:
    """Build the variants, print each one's times beside the kernel's;
    returns {shape: {variant: [ms, ...]}}."""
    require_card()
    fa.build_kernels()
    libs = build_variants()
    rows = {}
    for shape in K2_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        o, lse = variant_k2(libs["k2_nc2"], q, k, v)
        ref_o, ref_lse = fa.flash_attention_lse_plain(q, k, v)
        rel = ((o - ref_o).norm() / ref_o.norm()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        rows[shape] = _in_turns({
            "base": lambda: fa.flash_attention_lse(q, k, v),
            "k2_nc2": lambda: variant_k2(libs["k2_nc2"], q, k, v)}, 20)
        print(f"K2 f32 {shape}: k2_nc2 o relative L2 {rel:.3e}, lse "
              f"{lse_err:.3e}; ms {rows[shape]}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(42)
    q, k, v = (torch.randn(D512_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    ref = fa.flash_attention_plain(q, k, v)
    o = variant_d512(libs["d512_pass1"], q, k, v)
    rel = ((o - ref).norm() / ref.norm()).item()
    fns = {"base": lambda: fa.flash_attention_bhtd(q, k, v)}
    fns.update({name: functools.partial(variant_d512, libs[name], q, k, v)
                for name in VARIANTS if name.startswith("d512")})
    rows[D512_SHAPE] = _in_turns(fns, 5)
    print(f"K1 f32 {D512_SHAPE}: d512_pass1 relative L2 {rel:.3e}; ms "
          f"{rows[D512_SHAPE]}", flush=True)
    return rows


if __name__ == "__main__":
    main()
