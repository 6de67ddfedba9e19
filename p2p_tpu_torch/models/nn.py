"""NN primitives as plain functions on tensors.

The PyTorch counterpart of ``p2p_tpu/models/nn.py``. Weights are torch
layouts (Linear ``(out, in)``, Conv ``(O, I, kH, kW)``); spatial tensors are
NCHW inside the models (cuDNN's layout), and the models convert at their
public boundary to the JAX package's NHWC.

In f32 every function is one PyTorch call. In a 16-bit dtype (bf16, the
JAX package's production dtype) each function rounds where the JAX
package's compiled program rounds on the CPU: XLA rounds each primitive's
result to the carrier dtype, except where it computes a chain in f32 and
drops the round trip in between (the argument of ``erfc`` in :func:`gelu`,
the centred values of the norms' variance). So a product rounds before its
bias is added, the logistic is ``1 / (1 + exp(−x))`` rounded at each step,
and the norms take f32 statistics with the JAX package's shifted two-pass
arithmetic (:func:`group_norm`). Weights come in the carrier dtype (cast
once per pipeline, ``engine.sampler.Pipeline.weights``) except the norms'
scale and bias, which stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _f32(x: torch.Tensor) -> bool:
    return x.dtype == torch.float32


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` for a residual stream that :func:`layer_norm` reads next.
    Below f32 the sum is taken in f32 and rounded, and the unrounded sum is
    kept on the result (``.unrounded``): the JAX program's layer norm takes
    its mean of the sum before it is rounded (XLA drops the round trip
    between the add and the f32 reduction; a group norm, which reshapes
    its input first, keeps it)."""
    if _f32(x):
        return x + y
    s = x.float() + y.float()
    out = s.to(x.dtype)
    out.unrounded = s
    return out


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if _f32(x) or bias is None:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Optional[int] = None) -> torch.Tensor:
    """NCHW convolution. ``padding=None`` is "same" for the odd kernels the
    models use (k // 2 on every side); an int pads symmetrically."""
    if padding is None:
        padding = weight.shape[-1] // 2
    if _f32(x) or bias is None:
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)
    return F.conv2d(x, weight, stride=stride, padding=padding) + bias[:, None, None]


def _stat_sum(c: torch.Tensor, shape, order) -> torch.Tensor:
    """``c`` (bf16) summed to ``shape``, a norm's statistic's, as the JAX
    program's compiled backward sums a broadcast's cotangent: in bf16 with
    the running sum rounded at every add, windowed as XLA's CPU compiler
    windows it, over the broadcast dimensions taken in the JAX package's
    order (``order``: the dimensions of ``c`` in that order)
    (``kernels.reduce``)."""
    from ..kernels.reduce import broadcast_sum

    return broadcast_sum(c, shape, order)


def _norm_stats(x: torch.Tensor, src: Optional[torch.Tensor], red):
    """The shifted two-pass statistics of a bf16 norm over ``red``: the f32
    mean (of ``src``, the unrounded input, where there is one) rounded to
    bf16, the rounding's residual in f32, and the variance, the centred
    values' f32 variance less the residual's square."""
    mean = (x.float() if src is None else src).mean(dim=red, keepdim=True)
    m16 = mean.to(x.dtype)
    cvar = (x.float() - m16.float()).square().mean(dim=red, keepdim=True)
    resid = mean - m16.float()
    return m16, resid, cvar - resid.square()


def _norm_input_cotangent(x, m16, resid, var, rsq, dc1, d_inv, d_resid_shift,
                          n, eps, sum_mean):
    """The rest of a bf16 norm's backward, shared by both norms, in the
    order and with the roundings of the JAX program's compiled backward
    (``jax.jit(jax.vjp(nn.layer_norm / nn.group_norm, x)[1])``'s HLO on
    the CPU): the variance's cotangent in f32 from ``d_inv`` (the f32
    cotangent of ``rsqrt(var + eps)``), the centred values' cotangent
    rounded twice (the variance's part, then with ``dc1``, the output
    product's part), the mean's through its bf16 rounding and the
    residual, and the input's as the centred values' plus the mean's
    share rounded; ``n`` values a statistic. ``sum_mean`` sums the centred
    values' cotangent to the rounded mean's shape (the windowed bf16
    sum)."""
    d_var = d_inv * ((rsq / (var + eps)) * -0.5)
    dcv = ((x.float() - m16.float()) * (d_var * (2.0 / n))).to(x.dtype)
    dc = dc1 + dcv
    dm16 = -sum_mean(dc)
    d_resid = d_resid_shift + (-d_var) * (resid * 2.0)
    d_mean = d_resid + ((-d_resid).to(x.dtype).float() + dm16.float())
    return dc + (d_mean * (1.0 / n)).to(x.dtype)


def _group_norm_lowp(xg, weight, bias, eps):
    """The bf16 group norm of :func:`group_norm` on the grouped NCHW input
    ``xg`` ``(n, g, c/g, *pixels)``: the output and what its backward
    keeps."""
    g, cg = xg.shape[1], xg.shape[2]
    expand = (None,) * (xg.dim() - 3)
    m16, resid, var = _norm_stats(xg, None, tuple(range(2, xg.dim())))
    scale = weight.float().reshape(g, cg)[(..., *expand)]
    rsq = torch.rsqrt(var + eps)
    inv = rsq * scale
    shift = bias.float().reshape(g, cg)[(..., *expand)] - resid * inv
    inv16 = inv.to(xg.dtype)
    y = (xg - m16) * inv16 + shift.to(xg.dtype)
    return y, (xg, m16, resid, var, rsq, scale, inv16)


def _layer_norm_lowp(x, src, weight, bias, eps):
    """The bf16 layer norm of :func:`layer_norm`: the output and what its
    backward keeps."""
    m16, resid, var = _norm_stats(x, src, -1)
    rsq = torch.rsqrt(var + eps)
    scale_shift = bias.float() - resid * rsq * weight.float()
    inv16 = rsq.to(x.dtype)
    y = ((x - m16) * inv16) * weight.to(x.dtype) + scale_shift.to(x.dtype)
    return y, (x, m16, resid, var, rsq, inv16, weight)


class _GroupNormLowp(torch.autograd.Function):
    """:func:`_group_norm_lowp` with the backward the JAX program compiles
    (:func:`_norm_input_cotangent`): the shift's and the inverse
    deviation's cotangents summed over the pixels in bf16
    (:func:`_stat_sum`), the rest in f32 and rounded where XLA rounds."""

    @staticmethod
    def forward(ctx, xg, weight, bias, eps):
        y, saved = _group_norm_lowp(xg, weight, bias, eps)
        ctx.save_for_backward(*saved)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, c):
        xg, m16, resid, var, rsq, scale, inv16 = ctx.saved_tensors
        nhwc = [0, *range(3, xg.dim()), 1, 2]       # (n, pixels..., g, c/g)
        d_shift = _stat_sum(c, inv16.shape, nhwc).float()
        d_inv16 = _stat_sum((xg - m16) * c, inv16.shape, nhwc)
        d_inv = d_inv16.float() + resid * -d_shift
        d_rsq = (d_inv * scale).sum(dim=2, keepdim=True)
        d_resid = (-d_shift * (rsq * scale)).sum(dim=2, keepdim=True)
        dx = _norm_input_cotangent(
            xg, m16, resid, var, rsq, c * inv16, d_rsq, d_resid,
            xg[0, 0].numel(), ctx.eps, lambda dc: _stat_sum(dc, m16.shape, nhwc))
        return dx, None, None, None


class _LayerNormLowp(torch.autograd.Function):
    """:func:`_layer_norm_lowp` with the backward the JAX program compiles
    (:func:`_norm_input_cotangent`): the scale's product transposed in
    bf16, the inverse deviation's cotangent summed over the channels in
    bf16 (:func:`_stat_sum`), the shift's in f32."""

    @staticmethod
    def forward(ctx, x, src, weight, bias, eps):
        y, saved = _layer_norm_lowp(x, src, weight, bias, eps)
        ctx.save_for_backward(*saved)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, c):
        x, m16, resid, var, rsq, inv16, weight = ctx.saved_tensors
        cw = c * weight.to(x.dtype)
        d_inv16 = _stat_sum((x - m16) * cw, inv16.shape, None)
        d_ss = (-c.float() * weight.float()).sum(dim=-1, keepdim=True)
        d_inv = d_inv16.float() + resid * d_ss
        dx = _norm_input_cotangent(
            x, m16, resid, var, rsq, cw * inv16, d_inv, d_ss * rsq, x.shape[-1],
            ctx.eps, lambda dc: _stat_sum(dc, m16.shape, None))
        return dx, None, None, None, None


def _lowp_grad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether autograd records a bf16 norm of ``x``; raises if it would
    need the scale's or the bias's gradient, which the port's bf16 norms
    do not give."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return False
    if weight.requires_grad or bias.requires_grad:
        raise NotImplementedError("the bf16 norms give no gradient for "
                                  "their scale and bias")
    return True


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis 1 of an N C ... tensor, with
    ``min(groups, C)`` groups as the JAX package takes them.

    Below f32 (``p2p_tpu/models/nn.py:group_norm``): the statistics in f32,
    the tensor arithmetic in the carrier dtype. The tensor is centred by its
    mean rounded to the carrier dtype (exact for values near the mean), the
    variance is taken of the centred values in f32, and the rounding
    residual of the mean is folded into the shift; the f32 scale is folded
    into the inverse deviation before it is cast. Its backward is the JAX
    program's (:class:`_GroupNormLowp`)."""
    g = min(groups, x.shape[1])
    if _f32(x):
        return F.group_norm(x, g, weight, bias, eps)
    n, c = x.shape[:2]
    xg = x.reshape(n, g, c // g, *x.shape[2:])
    if _lowp_grad(x, weight, bias):
        y = _GroupNormLowp.apply(xg, weight, bias, eps)
    else:
        y = _group_norm_lowp(xg, weight, bias, eps)[0]
    return y.reshape(x.shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; below f32 the shifted two-pass
    arithmetic of :func:`group_norm` (``p2p_tpu/models/nn.py:layer_norm``),
    with the scale applied after the cast, in the carrier dtype, and the
    shift built from the f32 scale; the mean of a residual sum made by
    :func:`add` is taken of the sum before it was rounded. Its backward is
    the JAX program's (:class:`_LayerNormLowp`)."""
    if _f32(x):
        return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    src = getattr(x, "unrounded", None)
    if _lowp_grad(x, weight, bias):
        return _LayerNormLowp.apply(x, src, weight, bias, eps)
    return _layer_norm_lowp(x, src, weight, bias, eps)[0]


def carrier(value: float, x: torch.Tensor) -> float:
    """``value`` rounded to ``x``'s dtype, as JAX rounds a Python scalar
    that meets an array of that dtype."""
    return torch.tensor(value, dtype=x.dtype).item()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic; below f32 ``1 / (1 + exp(−x))``, one rounding a
    primitive, as XLA expands it."""
    if _f32(x):
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


class _SiluLowp(torch.autograd.Function):
    """``x·σ(x)`` below f32, with the backward the JAX program compiles: its
    transpose of the forward's primitives, each product and sum rounded to
    the carrier dtype (``jax.jit(jax.vjp(nn.silu, x)[1])``'s HLO on the
    CPU): ``c·σ + (x·c)·(σ·(1 − σ))``. Autograd's own backward of the
    forward's ops rounds in other places (PERF.md §6)."""

    @staticmethod
    def forward(ctx, x):
        s = sigmoid(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, c):
        x, s = ctx.saved_tensors
        return c * s + (x * c) * (s * (1.0 - s))


class _GeluLowp(torch.autograd.Function):
    """``jax.nn.gelu``'s ``0.5·x·erfc(−x·√½)`` below f32, the argument of
    ``erfc`` in f32 (XLA drops its round trip), with the backward the JAX
    program compiles: its transpose, each primitive rounded to the carrier
    dtype, ``erfc``'s derivative as ``−2/√π·exp(−e²)`` with ``2/√π`` and
    ``√½`` in the carrier dtype and ``e`` rounded, ``erfc(e)`` itself
    rounded from the f32 argument (the HLO of ``jax.jit(jax.vjp(nn.gelu,
    x)[1])`` on the CPU)."""

    @staticmethod
    def forward(ctx, x):
        r = carrier(math.sqrt(0.5), x)
        e = x.float() * -r
        f = torch.special.erfc(e).to(x.dtype)
        if ctx.needs_input_grad[0]:     # the rounded e only for the backward
            ctx.save_for_backward(x, e.to(x.dtype), f)
        return (0.5 * x) * f

    @staticmethod
    def backward(ctx, c):
        x, e, f = ctx.saved_tensors
        r = carrier(math.sqrt(0.5), x)
        d = ((((0.5 * x) * c) * carrier(-2.0 / math.sqrt(math.pi), x))
             * torch.exp(-(e * e))) * r
        return -d + (c * f) * 0.5


def silu(x: torch.Tensor) -> torch.Tensor:
    if _f32(x):
        return F.silu(x)
    return _SiluLowp.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU; below f32 ``jax.nn.gelu``'s ``0.5·x·erfc(−x·√½)``
    with √½ in the carrier dtype, the argument of ``erfc`` in f32."""
    if _f32(x):
        return F.gelu(x, approximate="none")
    return _GeluLowp.apply(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    if _f32(x):
        return x * torch.sigmoid(1.702 * x)
    return x * sigmoid(carrier(1.702, x) * x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps`` with
    flip_sin_to_cos=True, downscale_freq_shift=0): ``[cos | sin]`` halves."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialized softmax(q·kᵀ·scale) in f32 — the tensor prompt-to-prompt
    edits. q, k: (B, heads, S, D)."""
    sim = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        sim = sim + mask
    return torch.softmax(sim, dim=-1)


class _ProbsValueLowp(torch.autograd.Function):
    """``probs·v`` with the f32 ``probs`` rounded to ``v``'s dtype below
    f32, and the backward the JAX program compiles: the cotangent of the
    rounded probabilities is the product ``dout·vᵀ`` left in f32 (XLA drops
    its round trip through the carrier dtype before the f32 softmax reads
    it), and ``v``'s is ``probsᵀ·dout`` summed in f32 and rounded once."""

    @staticmethod
    def forward(ctx, probs, v):
        p16 = probs.to(v.dtype)
        ctx.save_for_backward(p16, v)
        return torch.einsum("bhqk,bhkd->bhqd", p16, v)

    @staticmethod
    def backward(ctx, dout):
        p16, v = ctx.saved_tensors
        d = dout.float()
        return (torch.einsum("bhqd,bhkd->bhqk", d, v.float()),
                torch.einsum("bhqk,bhqd->bhkd", p16.float(), d).to(v.dtype))


def probs_value(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``probs·v`` for f32 probabilities ``(B, heads, P, K)`` rounded to
    ``v``'s dtype, ``v`` ``(B, heads, K, D)``."""
    if _f32(v):
        return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return _ProbsValueLowp.apply(probs, v)


#: Self-attention at or above this many positions goes to the flash kernel
#: (the JAX package's threshold, ``models/nn.py:fused_attention``).
FLASH_MIN_SEQ = 2048


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Attention for sites the controller never reads. q, k, v:
    (B, heads, S, D). Unmasked self-attention with S ≥ 2048 (the U-Net's
    64²-pixel sites, the VAE's mid block) runs flash attention (the CUDA
    kernels on a CUDA tensor, their plain versions on a CPU one): the
    forward-only K1, or — when autograd records and q, k or v requires
    grad, as in the null-text inversion's gradient — K3 forward with K4 as
    its backward (``kernels.flash_bwd.FlashAttentionFunction``). Everything
    else is the materialized einsum."""
    s_q, s_k = q.shape[-2], k.shape[-2]
    if mask is None and s_q == s_k and s_q >= FLASH_MIN_SEQ:
        from ..kernels.flash import flash_attention
        from ..kernels.flash_bwd import FlashAttentionFunction

        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, scale)
        return flash_attention(q, k, v, scale)
    return probs_value(attention_probs(q, k, scale, mask), v)
