"""The bf16 kernels' arithmetic in plain PyTorch, for the CPU tests.

K1 at d = 40 and K2 also run on bf16 operands (``csrc/attn_bf16.cuh``),
and K1 at d = 64 and 512 on Hopper's ``wgmma`` (``csrc/flash_fwd_sm90.cu``): one
bf16 tensor-core product a term with f32 accumulation. A product of two
bf16 values is exact in f32, so the scores
are the exact products summed in f32; what sets these kernels apart from
their plain versions is where they round to bf16. :func:`flash` and
:func:`fused_edit_folded` compute what the kernels compute, step by step,
rounding where they round:

- K1 rounds the unnormalized probabilities ``p = 2^(s − m2)`` of each
  step of keys (:func:`k1_step`: the kernel's key tile; it holds the
  running max ``m2`` in base 2) to bf16 before ``p·v``, as the JAX
  library's flash kernel does; the row sum
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


def k1_step(d: int) -> int:
    """Keys a step of the bf16 K1/K3 kernel at head dim ``d``: 128 for
    ``flash_d64_sm90_kernel`` (d = 64) and ``flash_d512_sm90_kernel`` (d =
    512), 64 for ``flash_d40_bf16_kernel``."""
    return 128 if d in (64, 512) else 64


def k2_step(d: int) -> int:
    """Keys a step of ``edit_attn_bf16_kernel`` at head dim ``d``."""
    return 80 if d <= 80 else 64


def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
          step: int | None = None, normalized: bool = False,
          residuals: bool = False):
    """Softmax attention of bf16 ``q, k, v`` as the bf16 kernels compute it,
    ``step`` keys at a time (K1's, :func:`k1_step`, by default), P rounded
    unnormalized (K1) or ``normalized`` (K2); returns the f32 output before
    its final rounding, and with ``residuals`` (K1 only) ``(out, l, m)`` as
    K3 writes them: ``m`` the row max in natural units, ``l`` the row sum of
    the unrounded ``exp(s − m)``."""
    f32 = torch.float32
    step = step or k1_step(q.shape[-1])
    scale2 = torch.tensor(scale, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    if normalized:
        s = (q.float() @ k.float().transpose(-1, -2)) * scale2
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        p = p * (1.0 / p.sum(dim=-1, keepdim=True))
        return p.to(torch.bfloat16).float() @ v.float()
    m2 = torch.full(q.shape[:-1], -math.inf, dtype=f32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=f32, device=q.device)
    o = torch.zeros(q.shape, dtype=f32, device=q.device)
    fused = q.shape[-1] in (64, 512)   # the sm90 kernels: s·scale2 − m2 in one FMA
    for k0 in range(0, k.shape[-2], step):
        kt, vt = k[..., k0:k0 + step, :].float(), v[..., k0:k0 + step, :].float()
        s = q.float() @ kt.transpose(-1, -2)
        # The max of the scaled scores is the scaled max: rounding is monotonic.
        m_new = torch.maximum(m2, s.amax(dim=-1) * scale2)
        c = torch.exp2(m2 - m_new)
        if fused:   # exact product and difference in f64, rounded once
            p = torch.exp2((s.double() * scale2.double()
                            - m_new.double()[..., None]).float())
        else:
            p = torch.exp2(s * scale2 - m_new[..., None])
        l = l * c + p.sum(dim=-1)
        o = o * c[..., None] + p.to(torch.bfloat16).float() @ vt
        m2 = m_new
    if residuals:
        return o / l[..., None], l, m2 * math.log(2.0)
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
