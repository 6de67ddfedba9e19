"""K4: flash attention backward — wrapper, plain version, launch counts and
the autograd Function that pairs it with K3.

Replaces the JAX library's flash backward, the Pallas kernels
``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq`` that
``jax.grad`` runs through ``flash_attention_tpu``
(``p2p_tpu/models/nn.py``, configured by ``_flash_block_sizes``). The f32
CUDA kernels at d = 40 are ``csrc/flash_attn_bwd.cu``: two passes, dk/dv over key
tiles and dq over query tiles, each recomputing the probabilities from K3's
residuals ``(l, m)``, every product on the tensor cores in 3xTF32 (f32
accuracy; :mod:`.tf32` emulates it), deterministic (no atomics).
``di = Σ o·do`` is taken in PyTorch here, in f32, as the JAX rule takes it outside its kernels. Path
shapes: the U-Net's self sites of 2048 pixels or more under the null-text
inversion's gradient, ``(1, 8, 4096, 40)`` at SD-1.4 and, at head dim 64,
``(1, 5, 9216, 64)`` and ``(1, 10, 2304, 64)`` at SD-2.1 768-v and
``(1, 5, 4096, 64)`` at 512-base; each head dim has kernels of its own.

Both passes also take bf16 q, k, v and do (f32 ``l``, ``m``, ``di``; bf16
gradients), the gradient of a bf16 inversion: one bf16 tensor-core product
a term with f32 accumulation, rounding where the JAX library's kernels
round — ``p`` to bf16 before ``dv += pᵀ·do``, ``ds = (dp − di)·p·scale``
to bf16 after the scale before ``dk += dsᵀ·q`` and ``dq += ds·k``, the
sums once at the end. The plain passes round at the same points (the
identity in f32, where the scale stays at the end as the f32 kernels take
it). At both head dims, SD-1.4's 40 and SD-2.1's 64, the bf16 passes are
``flash_bwd_dkv_sm90_kernel`` and ``flash_bwd_dq_sm90_kernel``
(``csrc/flash_bwd_sm90.cu``, a library of its own, templated on the head
dim): Hopper's ``wgmma`` fed by TMA, 128 rows a block, the other side
streamed (64 queries a tile in dk/dv, 128 keys in dq), the products summed
in the ``wgmma`` accumulator across tiles. At d = 40 TMA lands each
40-column row in a 64-column box with zeros after it, so both head dims
share the tiles and the pipeline. These rounding points do not depend on
the tile, so the plain passes are their yardstick too. In f32 at d = 64
the passes are ``flash_bwd_dkv_tf32_sm90_kernel`` and
``flash_bwd_dq_tf32_sm90_kernel`` (``csrc/flash_bwd_tf32_sm90.cu``):
3xTF32 on ``wgmma`` fed by TMA, 128 rows a block, the other side streamed
in 32-row tiles that the block splits into hi and lo (and, for the
products that contract over them, a transposed copy), each tile's product
summed in an accumulator of its own (:func:`.tf32.flash_bwd_dkv_tiles`
and :func:`.tf32.flash_bwd_dq_tiles` emulate them). :func:`entry_for`
picks each pass's C entry: f32 at d = 40 stays on ``flash_attn_bwd.cu``.
bf16 launches count apart, in ``.bf16_launches``.

On CPU tensors each pass's wrapper (:func:`flash_attention_bwd_dkv`,
:func:`flash_attention_bwd_dq`) runs its plain version; on CUDA tensors it
launches its kernel or raises, and counts its launches in ``.launches``
(and by dtype and head dim in ``.by_head_dim``, as K1 and K3 count).
:class:`FlashAttentionFunction` is K3 forward + K4 backward for either
device, so the CPU tests exercise the same autograd wiring.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .flash import _count_head_dim, check_operands, flash_attention_residuals

#: Head dims the CUDA kernels are instantiated for: the U-Net's self sites
#: of 2048 pixels or more at SD-1.4 (40) and SD-2.1 (64).
SUPPORTED_HEAD_DIMS = (40, 64)


def _ds(p, dp, di, scale: float, dtype):
    """``ds = p∘(dp − di)`` as the next product takes it: in f32 unscaled
    (the f32 passes scale the sum at the end); below f32 scaled and
    rounded to ``dtype``, as the JAX library rounds ``ds·scale``."""
    ds = p * (dp - di)
    return ds if dtype == torch.float32 else (ds * scale).to(dtype).float()


def flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale: float,
                                  chunk: int = 1024):
    """``(dk, dv)`` by the kernel's formulas, materialized one chunk of
    query rows at a time: ``p = exp(s − (m + log l))``, ``dv = pᵀ·do``,
    ``ds = p∘(do·vᵀ − di)``, ``dk = scale·dsᵀ·q``; ``p`` and ``scale·ds``
    rounded to the operands' dtype before their products (:func:`_ds`),
    and the outputs in it."""
    dtype = q.dtype
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        qc, doc = q[..., sl, :], do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qc, k) * scale
                      - lse[..., sl, None])
        dv = dv + torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), doc)
        ds = _ds(p, torch.einsum("bhqd,bhkd->bhqk", doc, v), di[..., sl, None],
                 scale, dtype)
        dk_c = torch.einsum("bhqk,bhqd->bhkd", ds, qc)
        dk = dk + (dk_c * scale if dtype == torch.float32 else dk_c)
    return dk.to(dtype), dv.to(dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale: float,
                                 chunk: int = 1024):
    """``dq = scale·ds·k`` by the kernel's formulas, one chunk of query rows
    at a time; ``scale·ds`` rounded to the operands' dtype before the
    product, and the output in it."""
    dtype = q.dtype
    q, k, v, do = (t.float() for t in (q, k, v, do))
    lse = m + torch.log(l)
    dqs = []
    for s0 in range(0, q.shape[-2], chunk):
        sl = slice(s0, s0 + chunk)
        doc = do[..., sl, :]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", q[..., sl, :], k) * scale
                      - lse[..., sl, None])
        ds = _ds(p, torch.einsum("bhqd,bhkd->bhqk", doc, v), di[..., sl, None],
                 scale, dtype)
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
        dqs.append(dq * scale if dtype == torch.float32 else dq)
    return torch.cat(dqs, dim=-2).to(dtype)


def flash_attention_bwd_plain(q, k, v, o, do, l, m, scale: float):
    """``(dq, dk, dv)``: both plain passes, with ``di = Σ o·do``."""
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    return flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale), dk, dv


#: The library of each backward C entry: bf16, and f32 at d = 64, run on
#: Hopper's wgmma and TMA in libraries of their own.
ENTRIES = {f"p2p_flash_attn_bwd_{p}{sfx}": lib for p in ("dkv", "dq")
           for sfx, lib in (("", "flash_attn_bwd"), ("_bf16_sm90", "flash_bwd_sm90"),
                            ("_f32_sm90", "flash_bwd_tf32_sm90"))}
_BACKWARD: dict = {}


def entry_for(pass_: str, dtype: torch.dtype, d: int) -> str:
    """The C entry of K4's ``pass_`` (``"dkv"`` or ``"dq"``) that runs
    ``dtype`` at head dim ``d`` (40 or 64): the bf16 sm90 pass in bf16;
    in f32 the 3xTF32 sm90 pass at d = 64 and the ``mma.sync`` pass of
    ``flash_attn_bwd.cu`` at d = 40."""
    if dtype == torch.bfloat16:
        sfx = "_bf16_sm90"
    else:
        sfx = "_f32_sm90" if d == 64 else ""
    return f"p2p_flash_attn_bwd_{pass_}{sfx}"


def backward_entry(entry: str):
    """``(library, function)`` of a backward C entry, its argument types set
    once: q, k, v, do, m, l, di, the outputs (dk and dv, or dq); bh, sq, sk,
    d; scale, stream."""
    found = _BACKWARD.get(entry)
    if found is None:
        lib = build.library(ENTRIES[entry])
        fn = getattr(lib, entry)
        outs = 2 if "_dkv" in entry else 1
        fn.argtypes = [ctypes.c_void_p] * (7 + outs) + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        found = _BACKWARD[entry] = (lib, fn)
    return found


def _check(what, q, k, v, do, l, m, di):
    """Raise unless the operands are what the CUDA kernels take: q, k, v
    and do f32 or bf16 alike, l, m and di f32."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape != (b, h, sk, d) or v.shape != k.shape or do.shape != q.shape
            or any(t.shape != (b, h, sq) for t in (l, m, di))):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)} "
                         f"l{tuple(l.shape)} m{tuple(m.shape)} di{tuple(di.shape)}")
    check_operands(what, (("q", q), ("k", k), ("v", v), ("do", do)),
                   SUPPORTED_HEAD_DIMS, q.dtype)
    check_operands(what, (("l", l), ("m", m), ("di", di)), None)
    if l.device != q.device:
        raise ValueError(f"{what}: l on {l.device}, q on {q.device}")
    return b * h, sq, sk, d


def _launch(wrapper, pass_: str, operands, outs, scale: float) -> None:
    """One launch of ``pass_``'s C entry for the operands' dtype and head dim
    (:func:`entry_for`) into ``outs``, counted on ``wrapper``."""
    q, k, v, do, l, m, di = operands
    bh, sq, sk, d = _check(wrapper.__name__, *operands)
    entry = entry_for(pass_, q.dtype, d)
    lib, fn = backward_entry(entry)
    status = fn(*(t.data_ptr() for t in (q, k, v, do, m, l, di, *outs)), bh, sq, sk, d,
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, entry)
    if q.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    else:
        wrapper.launches += 1
    _count_head_dim(wrapper, q)


def flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale: float):
    """K4's dk/dv pass: ``(dk, dv)`` from q/do ``(B, H, Sq, D)``, k/v
    ``(B, H, Sk, D)``, K3's residuals ``l``, ``m`` and ``di = Σ o·do``
    ``(B, H, Sq)``; contiguous, q, k, v and do f32 or bf16 (the gradients
    in their dtype), ``l``, ``m`` and ``di`` f32."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, l, m, di, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_attention_bwd_dkv, "dkv", (q, k, v, do, l, m, di), (dk, dv), scale)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, l, m, di, scale: float):
    """K4's dq pass: ``dq`` from the same operands as the dk/dv pass."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, l, m, di, scale)
    dq = torch.empty_like(q)
    _launch(flash_attention_bwd_dq, "dq", (q, k, v, do, l, m, di), (dq,), scale)
    return dq


def flash_attention_bwd(q, k, v, o, do, l, m, scale: float):
    """K4: the gradients ``(dq, dk, dv)`` of ``o = softmax(q·kᵀ·scale)·v``
    given the output gradient ``do`` and K3's residuals ``l``, ``m``.
    ``di = Σ o·do`` is computed here, outside the kernels, in f32 from
    the operands widened first, as the JAX library's rule computes it."""
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, l, m, di, scale)
    return flash_attention_bwd_dq(q, k, v, do, l, m, di, scale), dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.bf16_launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.bf16_launches = 0
flash_attention_bwd_dkv.by_head_dim = {}
flash_attention_bwd_dq.by_head_dim = {}


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
