"""K1: flash attention forward — wrapper, plain version and launch count.

Replaces the JAX package's ``flash_attention_tpu`` (``p2p_tpu/models/nn.py``,
the Pallas TPU library kernel behind ``fused_attention``). The CUDA kernel is
``csrc/flash_attn.cu``: non-causal, unmasked ``softmax(q·kᵀ·scale)·v`` in f32,
blockwise with an online softmax, so the (S, S) scores never exist in device
memory. Main-path shapes: the U-Net's 64²-pixel self sites, q/k/v
``(4, 8, 4096, 40)``, and the VAE decoder's mid attention ``(2, 1, 4096, 512)``.

On a CPU tensor the wrapper runs :func:`flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: Head dims the CUDA kernel is instantiated for.
SUPPORTED_HEAD_DIMS = (40, 64, 80, 160, 512)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, chunk: int = 1024) -> torch.Tensor:
    """Materialized f32 softmax attention, chunked over queries so the
    (S, S) scores exist only one chunk of rows at a time."""
    outs = []
    for s0 in range(0, q.shape[-2], chunk):
        qc = q[..., s0:s0 + chunk, :].float()
        probs = torch.softmax(
            torch.einsum("bhqd,bhkd->bhqk", qc, k.float()) * scale, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, v.float()))
    return torch.cat(outs, dim=-2).to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attn")
    fn = lib.p2p_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` for q ``(B, H, Sq, D)``, k/v
    ``(B, H, Sk, D)``, f32, contiguous."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous f32 "
                             f"on {q.device}, got {t.dtype} on {t.device}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    lib = _lib()
    out = torch.empty_like(q)
    status = lib.p2p_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, sk, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "p2p_flash_attn_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
