"""CPU models of the tensor-core products of the port's float32 kernels.

``csrc/mma_tf32.cuh`` splits each float32 operand x into TF32 halves,
hi = tf32(x) and lo = tf32(x - hi), and takes a b as a_lo b_hi + a_hi b_lo +
a_hi b_hi ("3xTF32"); each product of TF32 values is exact in float32 and the
sums are float32. These functions do the same on float32 torch tensors, so the
tests can hold the rounding against the JAX package's float32 tolerance.
"""

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (its top 19 bits), to nearest with ties away from zero: the
    kernels' ``tf32()`` on the bits of a float32 tensor."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the lo*lo term dropped."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass: each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)
