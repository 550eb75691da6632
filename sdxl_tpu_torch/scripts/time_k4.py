"""Times K4's bf16 forms on the card against F.linear, to choose between
them: the GEMV and the GEMM around GEMV_MAX_M, and the GEMM's tile (NT
rows of x a block) and K split around k4_gemm_plan's choice.

  python3 -m sdxl_tpu_torch.scripts.time_k4   (from the repo root)

Cases: FLUX.1-dev's linears at 1024x1024 (the single blocks' proj_out
[4608, 15360 -> 3072] at int8 and int4, the MLP at 4096 rows, the context
stream at 512), its modulation matvecs at 1-5 rows, SDXL's cross k over 154
context rows and lin_embed at its CFG pair, each with a bias. Each form and
plan is timed as ms per call inside one CUDA graph of 20 calls, random
normal inputs from a seed, and checked against quant_linear_plain (max
abs error within 2e-2 of max(1, max|y|)). Prints one line per case with
k4_gemm_plan's pick, the card's name and power limit, and last a JSON
object {case: {form or plan: ms}}.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from sdxl_tpu_torch.ops import quant as q
from sdxl_tpu_torch.scripts.timing import graph_time

# (what, M, K, N, bits)
CASES = [
    ("FLUX.1 proj_out", 4608, 15360, 3072, 8),
    ("FLUX.1 proj_out int4", 4608, 15360, 3072, 4),
    ("FLUX.1 mlp in", 4096, 3072, 12288, 8),
    ("FLUX.1 mlp out int4", 4096, 12288, 3072, 4),
    ("FLUX.1 context to_q", 512, 3072, 3072, 8),
    ("SDXL cross k", 154, 2048, 1280, 8),
    *((f"FLUX.1 double mod M={m}", m, 3072, 18432, 8) for m in range(1, 6)),
    ("FLUX.1 single mod", 1, 3072, 9216, 8),
    ("FLUX.1 double mod int4", 2, 3072, 18432, 4),
    ("SDXL lin_embed", 2, 1280, 1280, 8),
]
GRAPH_CALLS = 20
TILES_SPLITS = [(nt, 1) for nt in q.GEMM_TILES]


def graph_ms(fn) -> float:
    def run():
        for _ in range(GRAPH_CALLS):
            fn()
    return graph_time(run, 5) * 1e3 / GRAPH_CALLS


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("this timing runs on a CUDA device")
    bf16, out = torch.bfloat16, {}
    for label, m, k, n, bits in CASES:
        g = torch.Generator(device="cuda").manual_seed(m + k + n + bits)
        x = torch.randn((m, k), generator=g, device="cuda").to(bf16)
        p = q.quantize_weight(
            torch.randn((n, k), generator=g, device="cuda") * 0.02, bits)
        b = torch.randn((n,), generator=g, device="cuda").to(bf16)
        ref = q.quant_linear_plain(x, p, b).float()
        w = q.dequant_weight_plain(p, bf16)
        times = {"F.linear": graph_ms(lambda: F.linear(x, w, b))}
        pick = q.k4_gemm_plan(m, n, k, bits)
        runs = [("gemv", None)] if m <= q.GEMV_MAX_M else []
        runs += [("gemm", plan) for plan in dict.fromkeys(
            TILES_SPLITS + [pick])]
        for form, plan in runs:
            y = q._launch(x, p, b, bits, n, form=form, plan=plan).float()
            err = (y - ref).abs().max().item() / max(
                1.0, ref.abs().max().item())
            if not (bool(torch.isfinite(y).all()) and err <= 2e-2):
                raise SystemExit(f"{label} {form} {plan}: max error {err}")
            times[f"{form}{'' if plan is None else plan}"] = graph_ms(
                lambda: q._launch(x, p, b, bits, n, form=form, plan=plan))
        print(f"[{m}, {k} -> {n}] int{bits} {label} (k4_form "
              f"{q.k4_form(m, bf16, bits)}, k4_gemm_plan {pick}): " +
              " | ".join(f"{key} {ms:.4f}" for key, ms in times.items()),
              flush=True)
        out[label] = times
        del x, p, b, ref, w
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
