"""X1: the exp2 flash forward with the scale applied to the f32 logits, on
the card (counterpart of scripts/exp_flash_exp2.py).

    s = (q kᵀ) * (d^-0.5 * log2 e)   in f32
    p = exp2(s - m_new);  alpha = exp2(m_prev - m_new)

with m, l and acc in f32, p rounded to bf16 for P V and the output
acc / l in bf16. It differs from K1 (``flash_attention_bhtd``), which
folds the scale into q and rounds q to bf16 first, by that rounding:
``main()`` prints the error against K1, as the reference does.

The kernel is ``csrc/flash_experiments.cu``, templated on the tile (BQ,
BK); the reference's 512-4096 VMEM blocks become BQ in (64, 128) and BK in
(64, 128) (``TILES``), which a 227 KB shared memory holds. The wrapper
raises unless the tile divides T: at such a T the reference leaves the
last query rows unwritten and drops the last keys.

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

# the kernel's tiles (BQ, BK): query rows and keys a block holds
TILES = ((64, 64), (64, 128), (128, 64), (128, 128))
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
    tq, tk = q.shape[2], k.shape[2]
    if tq != tk or tq % block_q or tk % block_k:
        raise ValueError(
            f"{what}: the tile ({block_q}, {block_k}) must divide T (and "
            f"Tq == Tk), not Tq={tq} Tk={tk}: the reference leaves the last "
            f"query rows unwritten and drops the last keys there")


def launch_tiled(name: str, what: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, block_q: int, block_k: int,
                 tiles: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Launch one of the experiments' kernels (bf16, d = 64, a built tile,
    which the caller has checked divides T) on CUDA tensors; raise on
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
           block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """X1 over [B, H, T, D]; the tile (block_q, block_k) must divide T."""
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
