"""Design probes of X3 (csrc/flash_pipelined.cu), on the card: each
variant is the source with one edit, built into its own library beside the
kernels' and timed in turns against X3 as it is, at every X3 tile on the
reference's two shapes.

  k1_schedule  the same exports on K1's schedule (PIPE 0: S, softmax and
               P V of a tile in turn, one release a stage): the same
               function at the same tile without the overlap, so X3 less
               it is what the overlap hides;
  stages3      X3 on a ring of three stages in place of two.

Each variant's output is held to X3's (max abs, printed; both compute the
same sums in the same order). Times are the kernels' alone (q pre-scaled
once, as ``chained_time`` of X2's qscaled kernel in chip_smoke.py), µs a
call in a chain of 10 captured as one CUDA graph, in turns; each
variant's blocks an SM are printed.

Run on the card: python -m sdxl_tpu_torch.scripts.probe_pipelined_kernels
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import flash_attention as fa
from .exp_flash_exp2 import SHAPES, launch_tiled, random_qkv, require_card
from .exp_flash_pipelined import TILES
from .probe_f32_kernels import bind_export, build_variants
from .timing import chained_time

SOURCE = "flash_pipelined.cu"
_STAGES = "constexpr int kX3Stages = 2;"
VARIANTS = {
    "k1_schedule": [(_STAGES, _STAGES.replace("2;", "0;"))],
    "stages3": [(_STAGES, _STAGES.replace("2;", "3;"))],
}


def variant_x3(fn, q, k, v):
    """One X3 export of a variant's library on pre-scaled q."""
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b * h, t, t, d, 0.0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def chained_in_turns(fns: dict, q, k, v) -> dict:
    """µs a call of each function by chained_time, in turns (a, b, ...,
    b, a)."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(chained_time(fns[name], q, k, v) * 1e6)
    return times


def main() -> dict:
    """Build the variants, print each one's error and times beside X3's;
    returns {(shape, tile): {"x3" | variant: [µs, ...]}}."""
    require_card()
    fa.build_kernels()
    libs = build_variants(SOURCE, VARIANTS)
    for name, lib in libs.items():
        blocks = lib.flash_pipelined_blocks_per_sm
        blocks.restype = ctypes.c_int
        blocks.argtypes = [ctypes.c_int] * 2
        print(f"{name}: blocks an SM " + ", ".join(
            f"{bq}x{bk} {blocks(bq // 64, bk)}" for bq, bk in TILES),
            flush=True)
    rows = {}
    for label, shape in SHAPES:
        q, k, v = random_qkv(shape)
        qf = fa._prescale_q(q)
        for bq, bk in TILES:
            export = f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}"
            fns = {"x3": functools.partial(
                launch_tiled, export, "flash_pipelined", block_q=bq,
                block_k=bk, tiles=TILES)}
            for name, lib in libs.items():
                fns[name] = functools.partial(
                    variant_x3, bind_export(lib, export, 4))
            want = fns["x3"](qf, k, v).float()
            errs = ", ".join(
                f"{name} {(f(qf, k, v).float() - want).abs().max():.1e}"
                for name, f in fns.items() if name != "x3")
            rows[shape, (bq, bk)] = times = chained_in_turns(fns, qf, k, v)
            print(f"{label} {bq}x{bk}: max abs against X3 {errs}; µs a call "
                  f"(chained, in turns) " + ", ".join(
                      f"{name} {[round(t, 1) for t in ts]}"
                      for name, ts in times.items()), flush=True)
    return rows


if __name__ == "__main__":
    main()
