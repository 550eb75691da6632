"""X3: the software-pipelined flash forward, on the card (counterpart of
scripts/exp_flash_pipelined.py).

K1's function on T that the tile divides (q pre-scaled in f32 and rounded
to bf16 before the kernel, as the reference does), so its plain version
is K1's, ``flash_attention_plain``. The TPU kernel ping-pongs the f32
logits between two VMEM buffers so that the next block's QK product
overlaps this block's softmax. The kernel is K1's own, ``flash_fwd_wgmma``
in ``csrc/flash_fwd_wgmma.cuh`` (TMA/mbarrier K/V ring, a producer
warpgroup, wgmma consumers), with the pipelined schedule
(``csrc/flash_pipelined.cu`` instantiates it at each tile): a consumer
warpgroup issues the next key tile's QK product into a second S fragment
before this tile's softmax and P V, so both products run under the
softmax (FlashAttention-3's intra-warpgroup overlap), and K and V stages
are freed apart. Tiles (BQ, BK) in (64, 128)^2 (``TILES``, BQ = 64 a
consumer warpgroup); the query tile, too, must divide T. ``main()`` times
K1 and each tile with ``chained_time`` and prints the error against K1.

CPU tests: ``pytest tests/test_torch_flash_experiments.py`` (the plain
version against the reference in interpret mode, and the exports against
the tiles).

Run on the card: python -m sdxl_tpu_torch.scripts.exp_flash_pipelined
"""

from __future__ import annotations

import functools

import torch

from ..ops.flash_attention import (
    _prescale_q,
    flash_attention_bhtd,
    flash_attention_plain,
)
from .exp_flash_exp2 import (
    SHAPES,
    check_tile,
    launch_tiled,
    random_qkv,
    require_card,
)
from .timing import chained_time

# the kernel's tiles (BQ, BK): query rows (64 a consumer warpgroup) and
# keys a stage
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))


def flash_pipelined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bq: int = 64, bk: int = 64) -> torch.Tensor:
    """X3 over [B, H, T, D]; the tile (bq, bk) must divide T."""
    check_tile("flash_pipelined", q, k, bq, bk)
    if q.shape[2] % bq:
        raise ValueError(
            f"flash_pipelined: the query tile {bq} must divide T, not "
            f"T={q.shape[2]}: the reference leaves the last query rows "
            f"unwritten there")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    return launch_tiled(f"sdxl_flash_pipelined_bf16_q{bq}_k{bk}",
                        "flash_pipelined", _prescale_q(q), k, v, bq, bk,
                        TILES)


def main() -> list:
    """Time K1 and X3 at every tile with chained_time on the reference's
    two shapes, with X3's error against K1; returns the printed rows."""
    require_card()
    rows = []
    for name, shape in SHAPES:
        q, k, v = random_qkv(shape)
        base = chained_time(flash_attention_bhtd, q, k, v)
        print(f"{name}: production {base*1e6:7.0f}us/call", flush=True)
        ref = flash_attention_bhtd(q, k, v).float()
        for bq, bk in TILES:
            f = functools.partial(flash_pipelined, bq=bq, bk=bk)
            err = (f(q, k, v).float() - ref).abs().max().item()
            dt = chained_time(f, q, k, v)
            print(f"  pipelined bq={bq} bk={bk}: {dt*1e6:7.0f}us/call "
                  f"(err {err:.1e})", flush=True)
            rows.append({"shape": shape, "tile": (bq, bk), "s": dt,
                         "production_s": base, "err_vs_production": err})
    return rows


if __name__ == "__main__":
    main()
