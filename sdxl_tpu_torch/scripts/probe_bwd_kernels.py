"""Design probes of the flash backward in csrc/flash_hopper_bwd.cu, on the
card: each variant is the source with one edit, built into its own library
beside the kernels' and timed in turns against the kernels as they are.

K3 bf16, at the bf16 LoRA step's two shapes (level 1 and level 2 of the
UNet at 1024x1024, batch 1):

  dq_nc2       K3a (`flash_bwd_dq_wgmma<64>`) with two consumer
               warpgroups (128 query rows a block) in place of three;
  dkv_nc2      K3b (`flash_bwd_dkv_wgmma<64>`) with two (128 keys a
               block);
  dq_stages2   K3a with a ring of two stages in place of three;
  dkv_stages3  K3b with three stages in place of two;
  dq_onegroup  K3a with S and dP committed as one group of products, so
               that exp2 waits for both (no overlap with dP);
  dkv_onegroup K3b likewise.

K3 f32 d=128 (`flash_bwd_dq_tf32<128>`, `flash_bwd_dkv_tf32<128>`), at an
f32 Flux-dev LoRA step's joint attention at 1024x1024 ([1,24,4608,128])
and at [1,2,1000,128]:

  dq128_n16      K3a with stages of 16 keys and a slot of each ring for
                 each consumer, in place of 32 keys and one slot of each
                 ring that the two consumers take in turns;
  dkv128_second2 K3b with one slot of the first ring (qf, dO) and two of
                 the second (qf^T, dO^T) in place of two and one;
  dkv128_in_tc   K3b with dk and dv summed in the tensor cores over every
                 tile (no fresh accumulator: both products issued
                 together, one wait a tile), in place of one fresh
                 accumulator taken in turn by dv's and dk's products.

Each variant's dq, dk and dv are held to the kernels' own (relative L2,
printed) before it is timed. Times are per call inside one CUDA graph of
20 calls (the device's time: at level 2 a call's host work is about as
long as the kernel), in turns.

Run on the card: python -m sdxl_tpu_torch.scripts.probe_bwd_kernels
"""

from __future__ import annotations

import torch

from ..ops import flash_attention as fa
from .exp_flash_exp2 import require_card
from .probe_f32_kernels import bind_export, build_variants
from .timing import graph_time

SOURCE = "flash_hopper_bwd.cu"
_DKV128_FRESH = """\
      fence_regs(p_hi);
      fence_regs(p_lo);
      float fresh[D / 2];
      mbar_wait(&bars.second_full[qt % P::kSecondFull],
                (qt / P::kSecondFull) & 1);
      wgmma_fence();
      output_tf32<P>(fresh, p_hi, p_lo, dot_hi);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(fresh);
      fence_regs(p_hi);
      fence_regs(p_lo);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) adv[i] += fresh[i];
      uint32_t z_hi[kSteps][4], z_lo[kSteps][4];
      split_fragment(dp, z_hi, z_lo);
      fence_regs(z_hi);
      fence_regs(z_lo);
      wgmma_fence();
      output_tf32<P>(fresh, z_hi, z_lo, qft_hi);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(fresh);
      fence_regs(z_hi);
      fence_regs(z_lo);
      mbar_arrive(&bars.second_empty[s]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) adk[i] += fresh[i];"""
_DKV128_IN_TC = """\
      uint32_t z_hi[kSteps][4], z_lo[kSteps][4];
      split_fragment(dp, z_hi, z_lo);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(z_hi);
      fence_regs(z_lo);
      mbar_wait(&bars.second_full[qt % P::kSecondFull],
                (qt / P::kSecondFull) & 1);
      wgmma_fence();
      output_tf32<P, true>(adv, p_hi, p_lo, dot_hi);
      output_tf32<P, true>(adk, z_hi, z_lo, qft_hi);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(z_hi);
      fence_regs(z_lo);
      mbar_arrive(&bars.second_empty[s]);"""
VARIANTS = {
    "dq_nc2": [("constexpr int kDqConsumers = D == 64 ? 3 : 2;",
                "constexpr int kDqConsumers = 2;")],
    "dkv_nc2": [("constexpr int kDkvConsumers = D == 64 ? 3 : 2;",
                 "constexpr int kDkvConsumers = 2;")],
    "dq_stages2": [("constexpr int kDqStages = 3;",
                    "constexpr int kDqStages = 2;")],
    "dkv_stages3": [("constexpr int kDkvStages = 2;",
                     "constexpr int kDkvStages = 3;")],
    "dq_onegroup": [
        ("product_kmajor<D, P>(sc, qf_addr, P::kResBox, k_addr);\n"
         "    wgmma_commit();",
         "product_kmajor<D, P>(sc, qf_addr, P::kResBox, k_addr);"),
        ("wgmma_wait<1>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int i = 0; i < 32;",
         "wgmma_wait<0>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int i = 0; i < 32;")],
    "dkv_onegroup": [
        ("product_kmajor<D, P>(sc, k_addr, P::kResBox, qf_addr);\n"
         "    wgmma_commit();",
         "product_kmajor<D, P>(sc, k_addr, P::kResBox, qf_addr);"),
        ("wgmma_wait<1>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int j = 0; j < 8;",
         "wgmma_wait<0>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int j = 0; j < 8;")],
    "dq128_n16": [("using DqTf32Plan128 = Tf32BwdPlan<128, 32, 1, 1, 2, false>;",
                   "using DqTf32Plan128 = Tf32BwdPlan<128, 16, 2, 2, 2, false>;")],
    "dkv128_second2": [
        ("using DkvTf32Plan128 = Tf32BwdPlan<128, 16, 2, 1, 4, true>;",
         "using DkvTf32Plan128 = Tf32BwdPlan<128, 16, 1, 2, 4, true>;")],
    "dkv128_in_tc": [(_DKV128_FRESH, _DKV128_IN_TC)],
}
# the variants of K3 f32 d=128, and its shapes; the others are K3 bf16's
F32_D128 = ("dq128_n16", "dkv128_second2", "dkv128_in_tc")
SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64)]
F32_D128_SHAPES = [(1, 24, 4608, 128), (1, 2, 1000, 128)]
GRAPH_CALLS = 20


def graphed_in_turns(fns: dict, iters: int = 5) -> dict:
    """ms per call of each function inside one CUDA graph of GRAPH_CALLS
    calls, timed in turns (a, b, ..., b, a)."""
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        fn = fns[name]
        times[name].append(graph_time(
            lambda: [fn() for _ in range(GRAPH_CALLS)], iters)
            * 1e3 / GRAPH_CALLS)
    return times


def _call_variant(lib, kernel: int, tensors, qf):
    """Launch K3a (kernel 1) or K3b (2) of qf's route from a variant's
    library on `tensors` (the f32 routes' scratch appended)."""
    b, h, t, d = qf.shape
    name = fa._TRAIN_ROUTES[qf.dtype, d][kernel]
    if qf.dtype == torch.float32:
        tensors += (fa._bwd_tf32_scratch(b * h, t, t, d, kernel == 1,
                                         qf.device),)
    _, n_ptr, n_float = fa._KERNELS[name]
    err = bind_export(lib, name, n_ptr, n_float)(
        *(x.data_ptr() for x in tensors), b * h, t, t, d,
        *([d ** -0.5] if n_float else []),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def variant_dq(lib, qf, k, v, do, lse, delta):
    """K3a's dq from a variant's library."""
    dq = torch.empty_like(qf)
    _call_variant(lib, 1, (qf, k, v, do, lse, delta, dq), qf)
    return dq


def variant_dkv(lib, qf, k, v, do, lse, delta):
    """K3b's dk and dv from a variant's library."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call_variant(lib, 2, (qf, k, v, do, lse, delta, dk, dv), qf)
    return dk, dv


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def main() -> dict:
    """Build the variants, print each one's times beside the kernels';
    returns {(dtype, shape): {kernel: {variant: [ms, ...]}}}."""
    require_card()
    fa.build_kernels()
    libs = build_variants(SOURCE, VARIANTS)
    rows = {}
    for dtype, shapes, names in (
            (torch.bfloat16, SHAPES, [n for n in libs if n not in F32_D128]),
            (torch.float32, F32_D128_SHAPES, list(F32_D128))):
        for shape in shapes:
            g = torch.Generator(device="cuda").manual_seed(43)
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                           .to(dtype) for _ in range(4))
            o, lse = fa.flash_attention_lse(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            qf = fa._prescale_q(q)
            args = (qf, k, v, do, lse, delta)
            dq = fa.launch_bwd_dq(*args)
            dk, dv = fa.launch_bwd_dkv(*args)
            dq_fns = {"base": lambda: fa.launch_bwd_dq(*args)}
            dkv_fns = {"base": lambda: fa.launch_bwd_dkv(*args)}
            for name in names:
                lib = libs[name]
                vdq = variant_dq(lib, *args)
                vdk, vdv = variant_dkv(lib, *args)
                print(f"{name} {shape} {dtype}: relative L2 against the "
                      f"kernels' dq {_rel(vdq, dq):.3e}, dk "
                      f"{_rel(vdk, dk):.3e}, dv {_rel(vdv, dv):.3e}",
                      flush=True)
                if "dkv" not in name:
                    dq_fns[name] = (lambda lib=lib: variant_dq(lib, *args))
                if "dq" not in name:
                    dkv_fns[name] = (lambda lib=lib: variant_dkv(lib, *args))
            rows[dtype, shape] = {"dq": graphed_in_turns(dq_fns),
                                  "dkv": graphed_in_turns(dkv_fns)}
            for kernel, times in rows[dtype, shape].items():
                print(f"K3 {dtype} {kernel} {shape} ms per call in a graph: "
                      f"{times}", flush=True)
            del q, k, v, do, o, lse, delta, qf, dq, dk, dv
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
