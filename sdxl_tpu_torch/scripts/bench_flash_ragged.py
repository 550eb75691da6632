"""K1 against the plain attention at every SDXL bucket's ragged token
counts, on the card (counterpart of scripts/bench_flash_ragged.py).

Checks the kernel's in-kernel ragged masking (max error against
``plain_ref`` below 3e-2, or it raises) and times both at the UNet's
level-1 and level-2 token counts and the VAE mid-block attention (bf16 at
d = 512, K1's tensor-core route): ``use_flash`` sends T >= 924 to the kernel, and
the speed-ups say whether it wins there.

Run on the card: python -m sdxl_tpu_torch.scripts.bench_flash_ragged
"""

from __future__ import annotations

import torch

from ..ops.attention import _plain_sdpa_bhtd
from ..ops.flash_attention import flash_attention_bhtd
from .exp_flash_exp2 import random_qkv, require_card
from .timing import timeit

# (B, H, T, D, label): B=2 is the CFG pair-batch; H is the SDXL level's
CASES = (
    (2, 10, 4096, 64, "L1 1024x1024 (aligned)"),
    (2, 10, 3952, 64, "L1 832x1216 (ragged)"),
    (2, 10, 3696, 64, "L1 704x1344 (smallest ragged)"),
    (2, 20, 1024, 64, "L2 1024x1024 (aligned)"),
    (2, 20, 988, 64, "L2 832x1216 (ragged)"),
    (2, 20, 924, 64, "L2 704x1344 (smallest ragged)"),
    (1, 1, 15808, 512, "VAE mid 832x1216 (ragged)"),
)
MAX_ERR = 3e-2


def plain_ref(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """The plain attention (counterpart of the reference's ``xla_ref``): q
    scaled in its own dtype, f32 logits and softmax, the weights cast to
    v's dtype before the second product — the port's unrouted attention,
    ``ops.attention._plain_sdpa_bhtd``."""
    return _plain_sdpa_bhtd(q, k, v)


def main() -> list:
    """Every case: K1's error against plain_ref, both times and the
    speed-up; raises if an error reaches 3e-2. Returns the printed rows."""
    require_card()
    print(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}",
          flush=True)
    rows = []
    for b, h, t, d, label in CASES:
        q, k, v = random_qkv((b, h, t, d))
        got = flash_attention_bhtd(q, k, v).float()
        err = (got - plain_ref(q, k, v).float()).abs().max().item()
        t_flash = timeit(flash_attention_bhtd, q, k, v, iters=30) * 1e6
        t_plain = timeit(plain_ref, q, k, v, iters=30) * 1e6
        speedup = t_plain / t_flash
        print(f"{label:36s} B{b} H{h:2d} T{t:5d} D{d:3d}  max_err {err:.2e}  "
              f"flash {t_flash:8.1f}us  plain {t_plain:8.1f}us  "
              f"speedup {speedup:5.2f}x", flush=True)
        if not err < MAX_ERR:
            raise AssertionError(f"{label}: max_err {err} >= {MAX_ERR}")
        rows.append({"case": (b, h, t, d), "label": label, "err": err,
                     "flash_us": t_flash, "plain_us": t_plain,
                     "speedup": speedup})
    return rows


if __name__ == "__main__":
    main()
