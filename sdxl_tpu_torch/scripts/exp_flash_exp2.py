"""X1: the exp2 flash forward with the scale applied to the f32 logits, on
the card (counterpart of scripts/exp_flash_exp2.py).

    s = (q kᵀ) * (d^-0.5 * log2 e)   in f32
    p = exp2(s - m_new);  alpha = exp2(m_prev - m_new)

with m, l and acc in f32, p rounded to bf16 for P V and the output
acc / l in bf16. It differs from K1 (``flash_attention_bhtd``), which
folds the scale into q and rounds q to bf16 first, by that rounding:
``main()`` prints the error against K1, as the reference does.

The kernel is K1's own, ``flash_fwd_wgmma`` in
``csrc/flash_fwd_wgmma.cuh`` (TMA/mbarrier K/V ring, a producer
warpgroup, wgmma consumers), with the scale moved onto the f32 logits;
``csrc/flash_experiments.cu`` instantiates it at each tile (BQ, BK). The
reference's 512-4096 VMEM blocks become BQ = 64 x (1, 2 or 3 consumer
warpgroups) and BK in (64, 128) (``TILES``), which a 227 KB shared memory
holds; (192, 128) is K1's tile. The wrapper raises unless the key tile
divides T and Tq == Tk (the reference drops the last keys otherwise); a
query tile may run past T (192 divides neither 1024 nor 4096): the kernel
zero-fills those rows and never stores them, where the reference would
leave the last rows unwritten.

CPU tests: ``pytest tests/test_torch_flash_experiments.py`` (the plain
version against the reference in interpret mode).

Run on the card: python -m sdxl_tpu_torch.scripts.exp_flash_exp2
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from ..ops.flash_attention import (
    _LOG2E,
    _acc,
    _check_cuda,
    _check_qkv,
    _launch,
    flash_attention_bhtd,
)
from .timing import timeit

# the kernel's tiles (BQ, BK): query rows (64 a consumer warpgroup) and
# keys a stage; K1_TILE is K1's own
TILES = ((64, 64), (64, 128), (128, 64), (128, 128), (192, 64), (192, 128))
K1_TILE = (192, 128)
# the reference's two shapes: SDXL-base UNet levels 1 and 2 at 1024x1024,
# pair-batched CFG
SHAPES = (("T4096 h10", (2, 10, 4096, 64)), ("T1024 h20", (2, 20, 1024, 64)))


def random_qkv(shape, seed: int = 0, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v ~ N(0, 1) in bf16, drawn on ``device`` from one seeded
    generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=device)
                 .to(torch.bfloat16) for _ in range(3))


def require_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("this experiment runs on a CUDA device")


def check_tile(what: str, q: torch.Tensor, k: torch.Tensor, block_q: int,
               block_k: int) -> None:
    """Raise unless Tq == Tk and the key tile divides T (the reference
    drops the last keys otherwise). A query tile may run past T: X1 and X2
    run K1's kernel, which zero-fills those rows and never stores them."""
    tq, tk = q.shape[2], k.shape[2]
    if tq != tk or tk % block_k:
        raise ValueError(
            f"{what}: the tile ({block_q}, {block_k})'s key tile must divide "
            f"T (and Tq == Tk), not Tq={tq} Tk={tk}: the reference drops the "
            f"last keys there")


def launch_tiled(name: str, what: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, block_q: int, block_k: int,
                 tiles: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Launch one of the experiments' kernels (bf16, d = 64, a built tile,
    which the caller has checked against T) on CUDA tensors; raise on
    anything else."""
    b, h, tq, tk, d = _check_qkv(what, q, k, v)
    _check_cuda(what, (q, k, v), {(torch.bfloat16, 64)})
    if (block_q, block_k) not in tiles:
        raise ValueError(f"{what}: no kernel at tile ({block_q}, {block_k});"
                         f" the tiles built are {tuple(tiles)}")
    out = torch.empty_like(q)
    _launch(name, (q, k, v, out), (b * h, tq, tk, d), (d ** -0.5 * _LOG2E,))
    return out


def flash2_plain(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of X1: f32 logits of the unscaled q, times
    d^-0.5 * log2(e) in f32, base-2 softmax in f32, p cast to v's dtype,
    f32 accumulate."""
    d = q.shape[-1]
    s = (_acc(q) @ _acc(k).transpose(-1, -2)) * (d ** -0.5 * _LOG2E)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return (_acc(p) @ _acc(v)).to(v.dtype)


def flash2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int = K1_TILE[0], block_k: int = K1_TILE[1]
           ) -> torch.Tensor:
    """X1 over [B, H, T, D]; block_k must divide T (see check_tile)."""
    check_tile("flash2", q, k, block_q, block_k)
    if q.device.type == "cpu":
        return flash2_plain(q, k, v)
    return launch_tiled(f"sdxl_flash2_bf16_q{block_q}_k{block_k}", "flash2",
                        q, k, v, block_q, block_k, TILES)


def main() -> list:
    """Time K1 and X1 at every tile on the reference's two shapes, with
    X1's error against K1; returns the printed rows."""
    require_card()
    rows = []
    for name, shape in SHAPES:
        q, k, v = random_qkv(shape)
        base = timeit(flash_attention_bhtd, q, k, v)
        print(f"{name}: current kernel {base*1e6:.0f}us", flush=True)
        ref = flash_attention_bhtd(q, k, v).float()
        for bq, bk in TILES:
            f = functools.partial(flash2, block_q=bq, block_k=bk)
            err = (f(q, k, v).float() - ref).abs().max().item()
            dt = timeit(f, q, k, v)
            print(f"  exp2 bq={bq} bk={bk}: {dt*1e6:.0f}us "
                  f"(err vs current {err:.1e})", flush=True)
            rows.append({"shape": shape, "tile": (bq, bk), "s": dt,
                         "current_s": base, "err_vs_current": err})
    return rows


if __name__ == "__main__":
    main()
