"""TF32 arithmetic on the CPU, for the tests of the f32 routes that run on
TF32 tensor cores in three passes (csrc/hopper_common.cuh): an operand is
rounded as ``cvt.rna.tf32.f32`` rounds it, or split into a high and a low
TF32 part."""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa bits, to
    nearest, ties away from zero (on the sign-magnitude bits, adding half
    an ulp and clearing the 13 low bits rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    """a @ b with TF32 operands summed in f32: one pass a_tf32 b_tf32, or
    three, a_hi b_hi + a_hi b_lo + a_lo b_hi with x_lo = tf32(x - x_hi)."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi
