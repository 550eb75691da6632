"""Design probes of the bf16 flash backward in csrc/flash_hopper_bwd.cu,
on the card: each variant is the source with one edit, built into its own
library beside the kernels' and timed in turns against the kernels as
they are, at the bf16 LoRA step's two shapes (level 1 and level 2 of the
UNet at 1024x1024, batch 1).

  dq_nc2       K3a (`flash_bwd_dq_wgmma<64>`) with two consumer
               warpgroups (128 query rows a block) in place of three;
  dkv_nc2      K3b (`flash_bwd_dkv_wgmma<64>`) with two (128 keys a
               block);
  dq_stages2   K3a with a ring of two stages in place of three;
  dkv_stages3  K3b with three stages in place of two;
  dq_onegroup  K3a with S and dP committed as one group of products, so
               that exp2 waits for both (no overlap with dP);
  dkv_onegroup K3b likewise.

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
         "    for (int i = 0;",
         "wgmma_wait<0>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int i = 0;")],
    "dkv_onegroup": [
        ("product_kmajor<D, P>(sc, k_addr, P::kResBox, qf_addr);\n"
         "    wgmma_commit();",
         "product_kmajor<D, P>(sc, k_addr, P::kResBox, qf_addr);"),
        ("wgmma_wait<1>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int j = 0;",
         "wgmma_wait<0>();\n    fence_regs(sc);\n#pragma unroll\n"
         "    for (int j = 0;")],
}
SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64)]
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


def variant_dq(lib, qf, k, v, do, lse, delta):
    """K3a's dq from a variant's library."""
    b, h, t, d = qf.shape
    dq = torch.empty_like(qf)
    err = bind_export(lib, "sdxl_flash_attention_bwd_dq_bf16", 7)(
        *(x.data_ptr() for x in (qf, k, v, do, lse, delta, dq)), b * h, t, t,
        d, d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return dq


def variant_dkv(lib, qf, k, v, do, lse, delta):
    """K3b's dk and dv from a variant's library."""
    b, h, t, d = qf.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = bind_export(lib, "sdxl_flash_attention_bwd_dkv_bf16", 8, 0)(
        *(x.data_ptr() for x in (qf, k, v, do, lse, delta, dk, dv)), b * h, t,
        t, d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return dk, dv


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def main() -> dict:
    """Build the variants, print each one's times beside the kernels';
    returns {shape: {kernel: {variant: [ms, ...]}}}."""
    require_card()
    fa.build_kernels()
    libs = build_variants(SOURCE, VARIANTS)
    rows = {}
    for shape in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_lse(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        qf = fa._prescale_q(q)
        args = (qf, k, v, do, lse, delta)
        dq = fa.launch_bwd_dq(*args)
        dk, dv = fa.launch_bwd_dkv(*args)
        dq_fns = {"base": lambda: fa.launch_bwd_dq(*args)}
        dkv_fns = {"base": lambda: fa.launch_bwd_dkv(*args)}
        for name, lib in libs.items():
            vdq = variant_dq(lib, *args)
            vdk, vdv = variant_dkv(lib, *args)
            print(f"{name} {shape}: relative L2 against the kernels' dq "
                  f"{_rel(vdq, dq):.3e}, dk {_rel(vdk, dk):.3e}, dv "
                  f"{_rel(vdv, dv):.3e}", flush=True)
            if not name.startswith("dkv"):
                dq_fns[name] = (lambda lib=lib: variant_dq(lib, *args))
            if not name.startswith("dq"):
                dkv_fns[name] = (lambda lib=lib: variant_dkv(lib, *args))
        rows[shape] = {"dq": graphed_in_turns(dq_fns),
                       "dkv": graphed_in_turns(dkv_fns)}
        for kernel, times in rows[shape].items():
            print(f"K3 bf16 {kernel} {shape} ms per call in a graph: "
                  f"{times}", flush=True)
    return rows


if __name__ == "__main__":
    main()
