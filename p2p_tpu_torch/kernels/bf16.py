"""The bf16 kernels' arithmetic in plain PyTorch, for the CPU tests.

K1 at d = 40 and 64, and K2, also run on bf16 operands
(``csrc/attn_bf16.cuh``): one bf16 tensor-core product a term with f32
accumulation. A product of two bf16 values is exact in f32, so the scores
are the exact products summed in f32; what sets these kernels apart from
their plain versions is where they round to bf16. :func:`flash` and
:func:`fused_edit_folded` compute what the kernels compute, step by step,
rounding where they round:

- K1 rounds the unnormalized probabilities ``p = 2^(s − m2)`` of each
  step of keys (the kernel holds the running max ``m2`` in base 2) to bf16
  before ``p·v``, as the JAX library's flash kernel does; the row sum
  takes them unrounded, and the output is divided by it and rounded once;
- K2 rounds the normalized probabilities ``p·(1/l)`` of whole rows, as the
  JAX edit kernel does; its fold (:func:`.fused_edit.fold_operands`, in f32)
  carries ``V1`` and ``V2`` as bf16 pairs ``hi + lo`` (``P·hi + P·lo``),
  and an edit row with two passes rounds the first pass's output before the
  second adds to it.

Summation order apart, the kernels on the card agree with these
(``chip_smoke.py`` holds them to their plain versions, which round as the
JAX package rounds).
"""

from __future__ import annotations

import math

import torch

#: Keys a step of ``flash_d40_bf16_kernel`` and ``flash_d64_bf16_kernel``.
K1_STEP = 64


def k2_step(d: int) -> int:
    """Keys a step of ``edit_attn_bf16_kernel`` at head dim ``d``."""
    return 80 if d <= 80 else 64


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          step: int = K1_STEP, normalized: bool = False) -> torch.Tensor:
    """Softmax attention of bf16 ``q, k, v`` as the bf16 kernels compute it,
    ``step`` keys at a time, P rounded unnormalized (K1) or ``normalized``
    (K2); returns the f32 output before its final rounding."""
    f32 = torch.float32
    scale2 = torch.tensor(scale, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    if normalized:
        s = (q.float() @ k.float().transpose(-1, -2)) * scale2
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        p = p * (1.0 / p.sum(dim=-1, keepdim=True))
        return p.to(torch.bfloat16).float() @ v.float()
    m2 = torch.full(q.shape[:-1], -math.inf, dtype=f32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=f32, device=q.device)
    o = torch.zeros(q.shape, dtype=f32, device=q.device)
    for k0 in range(0, k.shape[-2], step):
        kt, vt = k[..., k0:k0 + step, :].float(), v[..., k0:k0 + step, :].float()
        s = (q.float() @ kt.transpose(-1, -2)) * scale2
        m_new = torch.maximum(m2, s.amax(dim=-1))
        c = torch.exp2(m2 - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * c + p.sum(dim=-1)
        o = o * c[..., None] + p.to(torch.bfloat16).float() @ vt
        m2 = m_new
    return o / l[..., None]


def split(x: torch.Tensor):
    """``(hi, lo)``: ``hi = bf16(x)``, ``lo = bf16(x − hi)``."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def fused_edit_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, spec, operands: dict,
                      pairs: bool = True) -> torch.Tensor:
    """K2's output for bf16 ``q, k, v`` as its bf16 kernels compute it: the
    fold in f32 carried as bf16 pairs, then for each row of ``[uncond(B);
    base; edits(E)]`` the passes of :func:`.tf32.fused_edit_folded` by
    :func:`flash` with normalized P, each rounded to bf16 when it is
    stored. ``pairs=False`` rounds the folded values to bf16 alone instead
    (PERF.md: 1.005e-2 of the largest magnitude from the JAX kernel on a
    fractional transform over 100 keys, against 5.0e-3 with pairs)."""
    from .fused_edit import fold_operands

    bf16 = torch.bfloat16
    b_half = q.shape[0] // 2
    step = k2_step(q.shape[-1])

    def attend(qq, kk, vv):
        if isinstance(vv, tuple):   # a bf16 pair: P·hi + P·lo
            return sum(flash(qq, kk, x, scale, step, normalized=True) for x in vv)
        return flash(qq, kk, vv, scale, step, normalized=True)

    v1, v2, c1_zero, c2_zero = fold_operands(v[b_half + 1:], spec, operands)
    if pairs:
        (v1h, v1l), (v2h, v2l) = split(v1), split(v2)
        v1 = [(a, b) for a, b in zip(v1h, v1l)]
        v2 = [(a, b) for a, b in zip(v2h, v2l)]
    else:
        v1, v2 = v1.to(bf16), v2.to(bf16)
    rows = [attend(q[:b_half + 1], k[:b_half + 1], v[:b_half + 1]).to(bf16)]
    for e in range(len(v1)):
        out = torch.zeros_like(q[0])
        if not c1_zero[e]:
            out = attend(q[b_half], k[b_half], v1[e]).to(bf16)
        if not c2_zero[e]:
            b = b_half + 1 + e
            out = (out.float() + attend(q[b], k[b], v2[e])).to(bf16)
        rows.append(out[None])
    return torch.cat(rows)
