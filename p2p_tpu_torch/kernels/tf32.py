"""Plain emulation of the tensor-core arithmetic of the port's 3xTF32
kernels (``csrc/mma_tf32.cuh``: K1 at d = 512, both passes of K4).

A TF32 operand keeps the sign, the 8 exponent bits and the top 10 of f32's
23 mantissa bits. The kernels split each f32 operand ``x`` into ``hi =
tf32(x)`` and ``lo = tf32(x − hi)``, rounding to nearest with ties away from
zero as ``cvt.rna.tf32.f32`` does, and take a product as ``lo·hi + hi·lo +
hi·hi`` with an f32 accumulator ("3xTF32"); a product of two TF32 values is
exact in f32, so only the accumulation rounds. One TF32 product alone
("1xTF32") keeps about three decimal digits.

The tests use these functions to show what the kernels' arithmetic does to
an attention output; the main path does not call them.
"""

from __future__ import annotations

import torch

_LOW_BITS = 13           # f32 mantissa bits a TF32 value drops
_HALF = 1 << (_LOW_BITS - 1)
_MASK = ~((1 << _LOW_BITS) - 1)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32, to nearest with ties away from zero.
    f32 is sign and magnitude, so adding half of the dropped range to the
    bit pattern and clearing the dropped bits rounds the magnitude up at
    the half-way point whatever the sign; a carry into the exponent is the
    right result. Infinities and NaNs pass through unchanged."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _HALF) & _MASK).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x − hi)``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one TF32 tensor-core product: both operands rounded to
    TF32, the products summed in f32."""
    return tf32_round(a) @ tf32_round(b)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels take it: ``lo·hi + hi·lo + hi·hi`` of the
    split operands, each partial product exact and summed in f32, the two
    small terms first."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              mm=mm_3xtf32) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` in f32 with both products taken by ``mm``
    (:func:`mm_3xtf32`, :func:`mm_1xtf32`, or ``torch.matmul`` for plain
    f32)."""
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm(p, v) / p.sum(dim=-1, keepdim=True)
