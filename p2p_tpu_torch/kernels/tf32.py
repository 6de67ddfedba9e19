"""Plain emulation of the tensor-core arithmetic of the port's 3xTF32
kernels (``csrc/mma_tf32.cuh``: K1 and K3 at d = 40 and 512, both passes
of K4 at d = 40, K2's main kernel; on ``wgmma`` K1 and K3 at d = 64 in
``csrc/flash_fwd_tf32_sm90.cu`` and K4 at d = 64 in
``csrc/flash_bwd_tf32_sm90.cu``).

A TF32 operand keeps the sign, the 8 exponent bits and the top 10 of f32's
23 mantissa bits. The kernels split each f32 operand ``x`` into ``hi =
tf32(x)`` and ``lo = tf32(x − hi)``, rounding to nearest with ties away from
zero as ``cvt.rna.tf32.f32`` does, and take a product as ``lo·hi + hi·lo +
hi·hi`` with an f32 accumulator ("3xTF32"); a product of two TF32 values is
exact in f32, so only the accumulation rounds. One TF32 product alone
("1xTF32") keeps about three decimal digits. :func:`flash_d40` follows the
d = 40 kernel (``flash_d40_kernel``) step by step, and at d = 64 the
d = 64 one (``flash_fwd_tf32_sm90_kernel``, whose key tile is one 64-key
step):
the online softmax in base 2, each step's products in a fresh accumulator
added in f32, and the residuals converted back to natural units. :func:`fused_edit_folded`
follows K2 (``csrc/fused_edit.cu``): the fold in f32, then one or two such
passes a row. :func:`flash_bwd_dkv_tiles` and :func:`flash_bwd_dq_tiles`
follow K4's f32 passes at d = 64 (``flash_bwd_dkv_tf32_sm90_kernel``,
``flash_bwd_dq_tf32_sm90_kernel``) tile by tile.

The tests use these functions to show what the kernels' arithmetic does to
an attention output; the main path does not call them.
"""

from __future__ import annotations

import math

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


#: Keys per online-softmax step of the d = 40 and d = 64 kernels (the d = 64
#: kernel's key tile, ``BN`` in ``csrc/flash_fwd_tf32_sm90.cu``).
D40_STEP = 64


def flash_d40(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              mm=mm_3xtf32, step: int = D40_STEP):
    """``(out, l, m)`` of softmax attention as ``flash_d40_kernel`` (and,
    at d = 64, ``flash_fwd_tf32_sm90_kernel``) computes them: q scaled by
    ``scale·log2(e)`` (in f32, as the kernel scales its Q fragments), then per ``step`` keys the scores ``s`` by ``mm``, the
    running max ``m2 = max(m2, max s)`` and ``p = 2^(s − m2)``, the sum and
    output rescaled by ``2^(m2_old − m2)`` and ``p·v`` by ``mm`` added to
    the output in f32. Returns the output divided by ``l`` once, ``l`` and
    ``m = m2·ln 2``: the residual convention of
    :func:`.flash.flash_attention_residuals_plain`."""
    f32 = torch.float32
    scale2 = torch.tensor(scale, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    qs = q.float() * scale2
    m2 = torch.full(q.shape[:-1], -math.inf, dtype=f32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=f32, device=q.device)
    o = torch.zeros(q.shape, dtype=f32, device=q.device)
    for k0 in range(0, k.shape[-2], step):
        kt, vt = k[..., k0:k0 + step, :].float(), v[..., k0:k0 + step, :].float()
        s = mm(qs, kt.transpose(-1, -2))
        m_new = torch.maximum(m2, s.amax(dim=-1))
        c = torch.exp2(m2 - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * c + p.sum(dim=-1)
        o = o * c[..., None] + mm(p, vt)
        m2 = m_new
    return o / l[..., None], l, m2 * torch.tensor(math.log(2.0), dtype=f32)


def fused_edit_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, spec, operands: dict, mm=mm_3xtf32
                      ) -> torch.Tensor:
    """K2's output as its CUDA kernels compute it: the fold in f32
    (:func:`.fused_edit.fold_operands`), then for each row of ``[uncond(B);
    base; edits(E)]`` the passes of :func:`flash_d40`'s step algorithm with
    the main kernel's keys a step (:data:`.fused_edit.STEP_KEYS`) and its
    products by ``mm``: one pass ``(q_b, k_b, v_b)`` for the uncond rows and
    the base row; for an edit row the base pass ``(q_B, k_B, V1)`` unless
    ``c1 ≡ 0`` plus its own pass ``(q_e, k_e, V2)`` unless ``c2 ≡ 0``, each
    divided by its own row sum (zero when both are skipped). ``mm =
    torch.matmul`` gives the folded form in plain f32."""
    from .fused_edit import STEP_KEYS, fold_operands

    b_half = q.shape[0] // 2
    step = STEP_KEYS[q.shape[-1]]

    def attend(qq, kk, vv):
        return flash_d40(qq, kk, vv, scale, mm=mm, step=step)[0]

    v1, v2, c1_zero, c2_zero = fold_operands(v[b_half + 1:], spec, operands)
    rows = [attend(q[:b_half + 1], k[:b_half + 1], v[:b_half + 1])]
    for e in range(v1.shape[0]):
        out = torch.zeros_like(q[0], dtype=torch.float32)
        if not c1_zero[e]:
            out = attend(q[b_half], k[b_half], v1[e])
        if not c2_zero[e]:
            b = b_half + 1 + e
            out = out + attend(q[b], k[b], v2[e])
        rows.append(out[None])
    return torch.cat(rows).to(v.dtype)


#: Rows of a streamed tile of K4's f32 passes at d = 64: queries in dk/dv,
#: keys in dq (``BT`` in ``csrc/flash_bwd_tf32_sm90.cu``).
K4_F32_TILE = 32


def _lse2_scale2(l: torch.Tensor, m: torch.Tensor, scale: float):
    """``(lse2, scale2)`` in f32 as the kernels form them: ``lse2 =
    m·log2(e) + log2(l)`` and ``scale2 = scale·log2(e)``."""
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    return (m.float() * log2e + torch.log2(l.float()),
            torch.tensor(scale, dtype=torch.float32) * log2e)


def flash_bwd_dkv_tiles(q, k, v, do, l, m, di, scale: float, mm=mm_3xtf32,
                        tile: int = K4_F32_TILE):
    """``(dk, dv)`` as ``flash_bwd_dkv_tf32_sm90_kernel`` computes them: per
    tile of ``tile`` queries, ``sᵀ = mm(k, q_tᵀ)``, ``pᵀ = 2^(sᵀ·scale·log2(e)
    − lse2)``, ``dpᵀ = mm(v, do_tᵀ)``, ``dsᵀ = pᵀ∘(dpᵀ − di)``, and the
    tile's ``mm(pᵀ, do_t)`` and ``mm(dsᵀ, q_t)`` added to ``dv`` and ``dk``
    in f32; ``dk`` scaled once at the end."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse2, scale2 = _lse2_scale2(l, m, scale)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for q0 in range(0, q.shape[-2], tile):
        sl = slice(q0, q0 + tile)
        qt, dot = q[..., sl, :], do[..., sl, :]
        p = torch.exp2(mm(k, qt.transpose(-1, -2)) * scale2 - lse2[..., None, sl])
        ds = p * (mm(v, dot.transpose(-1, -2)) - di[..., None, sl].float())
        dv = dv + mm(p, dot)
        dk = dk + mm(ds, qt)
    return dk * scale, dv


def flash_bwd_dq_tiles(q, k, v, do, l, m, di, scale: float, mm=mm_3xtf32,
                       tile: int = K4_F32_TILE):
    """``dq`` as ``flash_bwd_dq_tf32_sm90_kernel`` computes it: per tile of
    ``tile`` keys, ``s = mm(q, k_tᵀ)``, ``p = 2^(s·scale·log2(e) − lse2)``,
    ``ds = p∘(mm(do, v_tᵀ) − di)``, and the tile's ``mm(ds, k_t)`` added to
    ``dq`` in f32; scaled once at the end."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse2, scale2 = _lse2_scale2(l, m, scale)
    dq = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], tile):
        sl = slice(k0, k0 + tile)
        kt, vt = k[..., sl, :], v[..., sl, :]
        p = torch.exp2(mm(q, kt.transpose(-1, -2)) * scale2 - lse2[..., None])
        ds = p * (mm(do, vt.transpose(-1, -2)) - di[..., None].float())
        dq = dq + mm(ds, kt)
    return dq * scale
