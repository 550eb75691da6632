"""Times the flash kernels of one checkout on the card, so that two
checkouts (a commit and its parent) can be compared in turns on one card:
run it from each, A, B, B, A, in one session.

  python3 sdxl_tpu_torch/scripts/time_train_kernels.py [--root DIR]

--root is the checkout whose ``sdxl_tpu_torch`` is built and timed (default:
the one this file is in); only the wrappers every checkout since the f32
backward's first kernels has (``flash_attention_bhtd``,
``flash_attention_lse``, ``launch_bwd_dq``, ``launch_bwd_dkv``,
``_prescale_q``) are called. Cases: K1 bf16 and f32 d=64 at
[2,10,4096,64]; K2 and K3a, K3b bf16 and f32 d=64 at [1,10,4096,64] (the
bf16 and f32 LoRA steps' level 1); K1, K2, K3a and K3b f32 d=128 at
[1,24,4608,128] (an f32 Flux-dev forward's and LoRA step's joint attention
at 1024x1024) and [1,2,1000,128]. Each is timed as ms per call inside one
CUDA graph of 20 calls (the device's time, no host launch between calls),
random normal inputs from seed 43. Prints one line per case, the card's
name and power limit, and last a JSON object {case: ms}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

CASES = [
    ("K1", torch.bfloat16, (2, 10, 4096, 64)),
    ("K1", torch.float32, (2, 10, 4096, 64)),
    ("K2", torch.bfloat16, (1, 10, 4096, 64)),
    ("K3a", torch.bfloat16, (1, 10, 4096, 64)),
    ("K3b", torch.bfloat16, (1, 10, 4096, 64)),
    ("K2", torch.float32, (1, 10, 4096, 64)),
    ("K3a", torch.float32, (1, 10, 4096, 64)),
    ("K3b", torch.float32, (1, 10, 4096, 64)),
    ("K1", torch.float32, (1, 24, 4608, 128)),
    ("K2", torch.float32, (1, 24, 4608, 128)),
    ("K3a", torch.float32, (1, 24, 4608, 128)),
    ("K3b", torch.float32, (1, 24, 4608, 128)),
    ("K1", torch.float32, (1, 2, 1000, 128)),
    ("K2", torch.float32, (1, 2, 1000, 128)),
    ("K3a", torch.float32, (1, 2, 1000, 128)),
    ("K3b", torch.float32, (1, 2, 1000, 128)),
]
GRAPH_CALLS = 20


def main() -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this timing runs on a CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from sdxl_tpu_torch.ops import flash_attention as fa
    from sdxl_tpu_torch.scripts.timing import graph_time

    print(f"timing the kernels of {fa.__file__}", flush=True)
    fa.build_kernels()
    times = {}
    for kernel, dtype, shape in CASES:
        g = torch.Generator(device="cuda").manual_seed(43)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_attention_lse(q, k, v)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (fa._prescale_q(q), k, v, do, lse, delta)
        call = {"K1": lambda: fa.flash_attention_bhtd(q, k, v),
                "K2": lambda: fa.flash_attention_lse(q, k, v),
                "K3a": lambda: fa.launch_bwd_dq(*bwd),
                "K3b": lambda: fa.launch_bwd_dkv(*bwd)}[kernel]
        ms = graph_time(lambda: [call() for _ in range(GRAPH_CALLS)],
                        5) * 1e3 / GRAPH_CALLS
        name = f"{kernel} {str(dtype).split('.')[-1]} {list(shape)}"
        times[name] = ms
        print(f"{name}: {ms:.4f} ms a call in a CUDA graph", flush=True)
        del q, k, v, do, o, lse, delta, bwd
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(times), flush=True)
    return times


if __name__ == "__main__":
    main()
