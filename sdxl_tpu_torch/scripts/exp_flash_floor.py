"""X2: timing variants of the flash forward, to split a call's time, on
the card (counterpart of scripts/exp_flash_floor.py).

  full      X1 (exp_flash_exp2.flash2);
  qscaled   the scale folded into q outside the kernel (q pre-scaled in
            f32 and rounded to bf16): K1's function;
  noexp     exp2 replaced by a linear shift, p = (s - m_new) * 0.01 + 0.5
            and alpha likewise. m starts at -inf, so the first key tile
            gives alpha = -inf, l = -inf * 0 and acc = 0 * -inf: the output
            is NaN everywhere, in the reference and here;
  mxu_only  p = the scaled logits rounded to bf16, no max and no l; the
            output is (sum p v) / 4096.

full - noexp is the exp2 cost, full - mxu_only the softmax bookkeeping,
full - qscaled the scale pass. The kernels are instances of K1's own,
``flash_fwd_wgmma`` in ``csrc/flash_fwd_wgmma.cuh``, which holds each
mode's arithmetic (``csrc/flash_experiments.cu`` exports them), at K1's
tile, 192 x 128: qscaled against K1 is the cost of K1's in-kernel q
pre-scale, and the split is that of the kernel the main path runs.
``main()`` times each mode, and K1, with ``chained_time``.

CPU tests: ``pytest tests/test_torch_flash_experiments.py``.

Run on the card: python -m sdxl_tpu_torch.scripts.exp_flash_floor
"""

from __future__ import annotations

import functools

import torch

from ..ops.flash_attention import (
    _LOG2E,
    _acc,
    _prescale_q,
    flash_attention_bhtd,
    flash_attention_plain,
)
from .exp_flash_exp2 import (
    K1_TILE,
    SHAPES,
    check_tile,
    flash2_plain,
    launch_tiled,
    random_qkv,
    require_card,
)
from .timing import chained_time

MODES = ("full", "qscaled", "noexp", "mxu_only")
TILE = K1_TILE


def _noexp_plain(q, k, v, block_k):
    """The noexp recurrence over key tiles of block_k, from m = -inf."""
    scale = q.shape[-1] ** -0.5 * _LOG2E
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), dtype=_acc(q).dtype, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(_acc(q))
    for j in range(0, k.shape[2], block_k):
        s = (_acc(q) @ _acc(k[:, :, j:j + block_k]).transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = (s - m_new) * 0.01 + 0.5
        alpha = (m - m_new) * 0.01 + 0.5
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _acc(p.to(v.dtype)) @ _acc(v[:, :, j:j + block_k])
        m = m_new
    return (acc / l).to(v.dtype)


def attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mode: str = "full", block_k: int = TILE[1]) -> torch.Tensor:
    """Plain PyTorch version of X2 in each mode (noexp's depends on the
    key tile, as the kernel's does; the others do not)."""
    if mode == "full":
        return flash2_plain(q, k, v)
    if mode == "qscaled":
        return flash_attention_plain(q, k, v)
    if mode == "noexp":
        return _noexp_plain(q, k, v, block_k)
    if mode == "mxu_only":
        s = (_acc(q) @ _acc(k).transpose(-1, -2)) * (q.shape[-1] ** -0.5
                                                     * _LOG2E)
        return ((_acc(s.to(v.dtype)) @ _acc(v)) * (1.0 / 4096.0)).to(v.dtype)
    raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")


def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mode: str = "full", bq: int = TILE[0], bk: int = TILE[1]
         ) -> torch.Tensor:
    """X2 in ``mode`` over [B, H, T, D]; bk must divide T (see
    check_tile)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    check_tile(f"attn({mode})", q, k, bq, bk)
    if q.device.type == "cpu":
        return attn_plain(q, k, v, mode, bk)
    if mode == "qscaled":
        q = _prescale_q(q)
    return launch_tiled(f"sdxl_flash_floor_{mode}_bf16", f"attn({mode})", q,
                        k, v, bq, bk, (TILE,))


def main() -> list:
    """Time every mode, and K1, with chained_time on the reference's two
    shapes; returns the printed rows."""
    require_card()
    rows = []
    for name, shape in SHAPES:
        q, k, v = random_qkv(shape)
        bq, bk = TILE
        dt = chained_time(flash_attention_bhtd, q, k, v)
        print(f"{name} K1        bq={bq} bk={bk}: {dt*1e6:7.0f}us/call",
              flush=True)
        rows.append({"shape": shape, "mode": "K1", "s": dt})
        for mode in MODES:
            dt = chained_time(functools.partial(attn, mode=mode), q, k, v)
            print(f"{name} {mode:9s} bq={bq} bk={bk}: {dt*1e6:7.0f}us/call",
                  flush=True)
            rows.append({"shape": shape, "mode": mode, "s": dt})
    return rows


if __name__ == "__main__":
    main()
