"""K4: flash attention backward — wrapper, plain version, launch counts and
the autograd Function that pairs it with K3.

Replaces the JAX library's flash backward, the Pallas kernels
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` that
``jax.grad`` runs through ``flash_attention_tpu``
(``p2p_tpu/models/nn.py``, configured by ``_flash_block_sizes``). The CUDA
kernels are ``csrc/flash_attn_bwd.cu``: two passes, dk/dv over key tiles
and dq over query tiles, each recomputing the probabilities from K3's
residuals ``(l, m)``, every product on the tensor cores in 3xTF32 (f32
accuracy; :mod:`.tf32` emulates it), deterministic (no atomics). ``di = Σ o·do`` is taken
in PyTorch here, as the JAX rule takes it outside its kernels. Path shape:
the U-Net's 64²-pixel self sites under the null-text inversion's gradient,
``(1, 8, 4096, 40)``.

On CPU tensors each pass's wrapper (:func:`flash_attention_bwd_dkv`,
:func:`flash_attention_bwd_dq`) runs its plain version; on CUDA tensors it
launches its kernel or raises, and counts its launches in ``.launches``.
:class:`FlashAttentionFunction` is K3 forward + K4 backward for either
device, so the CPU tests exercise the same autograd wiring.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .flash import check_operands, flash_attention_residuals

#: Head dims the CUDA kernels are instantiated for (the U-Net's 64²-pixel
#: self sites at SD-1.4).
SUPPORTED_HEAD_DIMS = (40,)


def flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale: float,
                                  chunk: int = 1024):
    """``(dk, dv)`` by the kernel's formulas, materialized one chunk of
    query rows at a time: ``p = exp(s − (m + log l))``, ``dv = pᵀ·do``,
    ``ds = p∘(do·vᵀ − di)``, ``dk = scale·dsᵀ·q``."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        qc, doc = q[..., sl, :], do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qc, k) * scale
                      - lse[..., sl, None])
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, doc)
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doc, v) - di[..., sl, None])
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
    return dk, dv


def flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale: float,
                                 chunk: int = 1024):
    """``dq = scale·ds·k`` by the kernel's formulas, one chunk of query rows
    at a time."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dqs = []
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        doc = do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q[..., sl, :], k) * scale
                      - lse[..., sl, None])
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", doc, v) - di[..., sl, None])
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale)
    return torch.cat(dqs, dim=-2)


def flash_attention_bwd_plain(q, k, v, o, do, l, m, scale: float):
    """``(dq, dk, dv)``: both plain passes, with ``di = Σ o·do``."""
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    return flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale), dk, dv


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attn_bwd")
    lib.p2p_flash_attn_bwd_dkv.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.p2p_flash_attn_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.p2p_flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.p2p_flash_attn_bwd_dq.restype = ctypes.c_int
    return lib


def _check(what, q, k, v, do, l, m, di):
    """Raise unless the operands are what the CUDA kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape != (b, h, sk, d) or v.shape != k.shape or do.shape != q.shape
            or any(t.shape != (b, h, sq) for t in (l, m, di))):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)} "
                         f"l{tuple(l.shape)} m{tuple(m.shape)} di{tuple(di.shape)}")
    check_operands(what, (("q", q), ("k", k), ("v", v), ("do", do), ("l", l),
                          ("m", m), ("di", di)), SUPPORTED_HEAD_DIMS)
    return b * h, sq, sk, d


def flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale: float):
    """K4's dk/dv pass: ``(dk, dv)`` from q/do ``(B, H, Sq, D)``, k/v
    ``(B, H, Sk, D)``, K3's residuals ``l``, ``m`` and ``di = Σ o·do``
    ``(B, H, Sq)``; f32, contiguous."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    bh, sq, sk, d = _check("flash_attention_bwd_dkv", q, k, v, do, l, m, di)
    lib = _lib()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    status = lib.p2p_flash_attn_bwd_dkv(
        *(t.data_ptr() for t in (q, k, v, do, m, l, di, dk, dv)), bh, sq, sk, d,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "p2p_flash_attn_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, l, m, di, scale: float):
    """K4's dq pass: ``dq`` from the same operands as the dk/dv pass."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)
    bh, sq, sk, d = _check("flash_attention_bwd_dq", q, k, v, do, l, m, di)
    lib = _lib()
    dq = torch.empty_like(q)
    status = lib.p2p_flash_attn_bwd_dq(
        *(t.data_ptr() for t in (q, k, v, do, m, l, di, dq)), bh, sq, sk, d,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "p2p_flash_attn_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, o, do, l, m, scale: float):
    """K4: the gradients ``(dq, dk, dv)`` of ``o = softmax(q·kᵀ·scale)·v``
    given the output gradient ``do`` and K3's residuals ``l``, ``m``.
    ``di = Σ o·do`` is computed here, outside the kernels, as the JAX
    library's rule computes it."""
    di = (o * do).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
    return flash_attention_bwd_dq(q, k, v, do, l, m, di, scale), dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``softmax(q·kᵀ·scale)·v`` with K3 as its forward (saving
    ``(q, k, v, o, l, m)``) and K4 as its backward. The JAX package's
    counterpart is the library kernel's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, l, m = flash_attention_residuals(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, l, m)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), l, m,
                                         ctx.scale)
        return dq, dk, dv, None
