"""Where the reference rounds: the points at which the port casts to its
compute dtype (conv, 1x1 and strided-conv operands, every Dense layer,
attention's p). The reference runs in fp32, where rounding is the
identity; the correctness control sets ``MANTISSA_BITS = 3`` and rounds
there to e4m3's three mantissa bits, the precision below the
configuration's bf16 (the exponent range stays fp32's, so no value
saturates and the control never gives NaN for range alone)."""
from __future__ import annotations

import torch

MANTISSA_BITS: int | None = None  # None: fp32, no rounding


def rnd(x: torch.Tensor) -> torch.Tensor:
    """x as fp32, rounded to MANTISSA_BITS bits of mantissa (to nearest,
    ties to even) when set."""
    x = x.float()
    if MANTISSA_BITS is None:
        return x
    drop = 23 - MANTISSA_BITS
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> drop) & 1
    bits = (bits + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return bits.view(torch.float32)


class Rounded(torch.autograd.Function):
    """rnd in the forward, and rnd of the cotangent in the backward (the
    port rounds the cotangents before its backward kernels too)."""

    @staticmethod
    def forward(ctx, x):
        return rnd(x)

    @staticmethod
    def backward(ctx, g):
        return rnd(g)


def cast(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The reference's stand-in for ``x.to(compute_dtype)``."""
    if MANTISSA_BITS is None:
        return x.float()
    return Rounded.apply(x)
