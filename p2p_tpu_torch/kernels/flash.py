"""K1 and K3: flash attention forward — wrappers, plain versions and launch
counts.

K1 (:func:`flash_attention`) replaces the JAX package's
``flash_attention_tpu`` (``p2p_tpu/models/nn.py``, the Pallas TPU library
kernel behind ``fused_attention``); K3 (:func:`flash_attention_residuals`)
replaces ``flash_attention_residuals``, the same Pallas kernel with
``save_residuals=True`` — also its forward rule under differentiation. Both
launch the CUDA kernel of ``csrc/flash_attn.cu``: non-causal, unmasked
``softmax(q·kᵀ·scale)·v`` in f32, blockwise with an online softmax, so the
(S, S) scores never exist in device memory; K3 also writes each row's max
``m`` and sum ``l`` of ``exp(s − m)``. At d = 512 the kernel runs on the
tensor cores in 3xTF32 (f32 accuracy; :mod:`.tf32` emulates it) and may
split the keys among several blocks (:func:`key_splits`); a second kernel
merges the partial outputs in a fixed order (:func:`merge_partials` is its
plain version). Main-path shapes: K1 at the U-Net's 64²-pixel self sites,
q/k/v ``(4, 8, 4096, 40)``, and the VAE's mid attention ``(2, 1, 4096,
512)`` (no split) and ``(1, 1, 4096, 512)`` (two splits, in the
inversion's encode and decode); K3 at ``(1, 8, 4096, 40)`` in the null-text
inversion's gradient steps.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its own launches in
``.launches``, and the merges of its split calls in ``.merge_launches``.
"""

from __future__ import annotations

import ctypes
import math

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


def flash_attention_residuals_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, scale: float,
                                    chunk: int = 1024):
    """``(out, l, m)`` materialized, chunked over queries: ``m`` the row
    max of ``s = q·kᵀ·scale``, ``l`` the row sum of ``exp(s − m)``, both
    f32 ``(B, H, Sq)`` — the JAX library's residual convention."""
    outs, ls, ms = [], [], []
    for s0 in range(0, q.shape[-2], chunk):
        s = torch.einsum("bhqd,bhkd->bhqk", q[..., s0:s0 + chunk, :].float(),
                         k.float()) * scale
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l[..., None])
        ls.append(l)
        ms.append(m)
    return (torch.cat(outs, dim=-2).to(v.dtype), torch.cat(ls, dim=-1),
            torch.cat(ms, dim=-1))


#: Rows of a query tile and of a key tile of the d = 512 kernel.
D512_TILE = 64
#: Most key splits the d = 512 kernel is given.
MAX_KEY_SPLITS = 16


def key_splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Key splits for the d = 512 kernel, which fills an SM with one block.
    None when ``blocks`` (query tiles × batch·heads) already cover every
    SM; else the fewest that minimize the waves per unit of work,
    ``⌈blocks·n / sms⌉ / n``, at most one split per key tile. At
    (1, 1, 4096, 512) that is 2 (128 blocks; 4 splits, two waves of 256
    blocks, measured 1.7 % slower on an H100)."""
    if blocks >= sms:
        return 1
    hi = max(1, min(key_tiles, MAX_KEY_SPLITS))
    return min(range(1, hi + 1), key=lambda n: (math.ceil(blocks * n / sms) / n, n))


def merge_partials(outs, ls, ms):
    """Plain version of the d = 512 kernel's merge: the attention output and
    residuals ``(out, l, m)`` over all keys from each key range's
    unnormalized output ``Σ_j exp(s_j − m_i)·v_j`` with its row max ``m_i``
    and row sum ``l_i``, combined in the order given."""
    m = ms[0]
    for mi in ms[1:]:
        m = torch.maximum(m, mi)
    out = torch.zeros_like(outs[0])
    l = torch.zeros_like(ls[0])
    for oi, li, mi in zip(outs, ls, ms):
        w = torch.exp(mi - m)
        l = l + w * li
        out = out + w[..., None] * oi
    return out / l[..., None], l, m


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attn")
    fn = lib.p2p_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_operands(what: str, tensors, head_dims) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned f32 CUDA
    tensor on the first one's device and the head dim (last axis of the
    first) is one the kernel is instantiated for."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte "
                             f"aligned f32 on {dev}, got {t.dtype} on {t.device}")
    d = tensors[0][1].shape[-1]
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")


def _launch(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, residuals: bool):
    """One launch of ``p2p_flash_attn_fwd``: ``(out, l, m, merged)``, with
    ``l`` and ``m`` None unless ``residuals``, and ``merged`` whether the
    call split the keys and so also launched the merge kernel."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    check_operands(what, (("q", q), ("k", k), ("v", v)), SUPPORTED_HEAD_DIMS)
    lib = _lib()
    out = torch.empty_like(q)
    l = m = None
    if residuals:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    nsplit, part = 1, None
    if d == 512:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = key_splits(-(-sq // D512_TILE) * b * h, -(-sk // D512_TILE), sms)
        if nsplit > 1:
            part = torch.empty(nsplit * b * h * sq * (d + 2), dtype=torch.float32,
                               device=q.device)
    status = lib.p2p_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
        None if part is None else part.data_ptr(), nsplit,
        b * h, sq, sk, d, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "p2p_flash_attn_fwd")
    return out, l, m, nsplit > 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K1: ``softmax(q·kᵀ·scale)·v`` for q ``(B, H, Sq, D)``, k/v
    ``(B, H, Sk, D)``, f32, contiguous."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    out, _, _, merged = _launch("flash_attention", q, k, v, scale,
                                residuals=False)
    flash_attention.launches += 1
    flash_attention.merge_launches += merged
    return out


def flash_attention_residuals(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float):
    """K3: ``(out, l, m)`` — K1's output plus each row's softmax sum ``l``
    and max ``m``, f32 ``(B, H, Sq)``; the forward the backward
    (:mod:`.flash_bwd`) pairs with."""
    if q.device.type == "cpu":
        return flash_attention_residuals_plain(q, k, v, scale)
    out, l, m, merged = _launch("flash_attention_residuals", q, k, v, scale,
                                residuals=True)
    flash_attention_residuals.launches += 1
    flash_attention_residuals.merge_launches += merged
    return out, l, m


flash_attention.launches = 0
flash_attention.merge_launches = 0
flash_attention_residuals.launches = 0
flash_attention_residuals.merge_launches = 0
