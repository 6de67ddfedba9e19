"""NN primitives as plain functions on tensors.

The PyTorch counterpart of ``p2p_tpu/models/nn.py``. Weights are torch
layouts (Linear ``(out, in)``, Conv ``(O, I, kH, kW)``); spatial tensors are
NCHW inside the models (cuDNN's layout), and the models convert at their
public boundary to the JAX package's NHWC. Only the f32 branches of the
norms are ported: statistics and arithmetic both in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, weight, bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Optional[int] = None) -> torch.Tensor:
    """NCHW convolution. ``padding=None`` is "same" for the odd kernels the
    models use (k // 2 on every side); an int pads symmetrically."""
    if padding is None:
        padding = weight.shape[-1] // 2
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the channel axis 1 of an N C ... tensor, with
    ``min(groups, C)`` groups as the JAX package takes them."""
    return F.group_norm(x, min(groups, x.shape[1]), weight, bias, eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


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
    probs = attention_probs(q, k, scale, mask).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
