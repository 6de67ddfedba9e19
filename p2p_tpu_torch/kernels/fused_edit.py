"""K2: fused edit attention — wrapper, plain version, the fold, launch counts.

Replaces the JAX package's ``edit_attention`` (``p2p_tpu/kernels/fused_edit.py``,
the Pallas ``_edit_kernel``): softmax attention with the prompt-to-prompt
edit applied inside it, so the ``(2B, heads, P, K)`` probability tensor
never reaches device memory. For every CFG row ``b`` of
``[uncond(B); base; edits(E)]``::

    probs  = softmax(q_b·k_bᵀ·scale)           key columns ≥ K masked
    base   = softmax(q_B·k_Bᵀ·scale)           the source prompt's row
    new    = base @ M                          Replace / Refine only
    new    = new·ra + probs·(1 − ra)           Refine only
    new    = new · eq                          Reweight only
    edited = new·α + (1 − α)·probs
    out    = (edited if b ≥ B + 1 else probs) @ v_b

with the operands of :func:`controllers.kernel_spec.edit_operands`.
:func:`edit_attention_plain` is that formula in plain PyTorch, on the
lane-padded key axis with the JAX package's mask value. The CUDA kernels
(``csrc/fused_edit.cu``) compute it folded: every operand scales a key
column, so for an edit row ``e``::

    out_e = softmax(q_B·k_Bᵀ·scale) @ V1_e + softmax(q_e·k_eᵀ·scale) @ V2_e
    V1_e  = M_e·diag(c1_e)·v_e                 c1 = ra·eq·α
    V2_e  = diag(c2_e)·v_e                     c2 = (1 − ra)·eq·α + (1 − α)

(:func:`fold_operands`): a fold kernel writes ``V1``, ``V2`` and the flags
``c1 ≡ 0``, ``c2 ≡ 0``, and the main kernel runs one or two softmax-attention
passes a row on the tensor cores in 3xTF32 (emulated by
:func:`.tf32.fused_edit_folded`). On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches both kernels or raises.

In bf16 (q, k, v bf16, the operands f32) the wrapper launches the bf16
entry: the same fold, reading bf16 values and writing ``V1``, ``V2`` as
bf16 hi/lo pairs, then each pass as one bf16 tensor-core pass with the
normalized P rounded to bf16 before P·V (two products with the folded
values, one with the row's own). The plain version rounds where the JAX kernel rounds: the edited
P to ``v``'s dtype before P·V, the output once. bf16 launches count apart,
in ``edit_attention.bf16_launches`` and ``.bf16_fold_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..controllers.kernel_spec import EditSpec, edit_operands, kernel_edit_spec
from . import build

#: Additive mask of the lane-padded key columns (the JAX kernel's value).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

#: Head dims the CUDA kernels are instantiated for.
SUPPORTED_HEAD_DIMS = (16, 32, 40, 64, 80, 160)

#: Keys per online-softmax step of the main kernel at each head dim
#: (``Tile<D>::BS``): a cross site's 77 keys are one step up to D = 40.
STEP_KEYS = {16: 80, 32: 80, 40: 80, 64: 40, 80: 40, 160: 32}


def edit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, spec: EditSpec, operands: dict
                         ) -> torch.Tensor:
    """The kernel's formula in plain PyTorch (f32), on keys padded to
    ``spec.pad_len`` with masked logits, as the JAX kernel computes it: the
    probabilities rounded to ``v``'s dtype before P·V (the identity in f32)
    and the output once at the end."""
    two_b = q.shape[0]
    b_half = two_b // 2
    kp = spec.pad_len
    pad = kp - k.shape[2]
    k_p = F.pad(k.float(), (0, 0, 0, pad))
    v_p = F.pad(v.float(), (0, 0, 0, pad))
    mask = torch.where(torch.arange(kp, device=q.device) < spec.key_len,
                       0.0, MASK_VALUE).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_p) * scale + mask
    probs = torch.softmax(logits, dim=-1)                   # (2B, H, P, Kp)
    base = probs[b_half]                                    # (H, P, Kp)
    edits = probs[b_half + 1:]                              # (E, H, P, Kp)
    if spec.has_transform:
        new = torch.einsum("hpw,ewn->ehpn", base, operands["transform"])
    else:
        new = base[None].expand_as(edits)
    if spec.kind == "refine":
        ra = operands["refine_mix"][:, None, None, :]
        new = new * ra + edits * (1.0 - ra)
    if spec.has_equalizer:
        new = new * operands["equalizer"][:, None, None, :]
    alpha = operands["blend"][:, None, None, :]
    edited = new * alpha + (1.0 - alpha) * edits
    probs = torch.cat([probs[:b_half + 1], edited], dim=0).to(v.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", probs, v_p).to(v.dtype)


def fold_operands(v_edits: torch.Tensor, spec: EditSpec, operands: dict):
    """The fold in f32, as the fold kernel computes it: ``(V1, V2, c1_zero,
    c2_zero)`` for the edit rows' values ``v_edits`` ``(E, H, K, D)``, with
    ``V1 = M·diag(c1)·v`` and ``V2 = diag(c2)·v`` ``(E, H, K, D)`` and the
    flags ``(E,)`` bool: ``c1`` (``c2``) is 0 on every key. Only the first K
    entries of each operand row are read."""
    k = spec.key_len
    e = v_edits.shape[0]
    ones = torch.ones((e, k), dtype=torch.float32, device=v_edits.device)

    def row(name):
        t = operands.get(name)
        return ones if t is None else t[:, :k]

    ra, eq, al = row("refine_mix"), row("equalizer"), operands["blend"][:, :k]
    c1 = ra * eq * al
    c2 = (1.0 - ra) * eq * al + (1.0 - al)
    v = v_edits.float()
    v1 = c1[:, None, :, None] * v
    if spec.has_transform:
        v1 = torch.einsum("ewn,ehnd->ehwd", operands["transform"][:, :k, :k], v1)
    return v1, c2[:, None, :, None] * v, (c1 == 0).all(dim=1), (c2 == 0).all(dim=1)


_ENTRY = []   # [(library, p2p_fused_edit_fwd)] once loaded


def _entry(bf16: bool):
    """``(library, entry)``: the f32 or the bf16 C entry point."""
    if not _ENTRY:
        lib = build.library("fused_edit")
        fns = (lib.p2p_fused_edit_fwd, lib.p2p_fused_edit_fwd_bf16)
        for fn, pointers in zip(fns, (11, 13)):
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _ENTRY.append((lib, fns))
    lib, fns = _ENTRY[0]
    return lib, fns[bf16]


def _operand(operands: dict, name: str, shape, device) -> Optional[torch.Tensor]:
    t = operands.get(name)
    if t is None:
        return None
    if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"edit_attention: operand {name} must be contiguous "
                         f"f32 {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def edit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, spec: EditSpec, operands: dict) -> torch.Tensor:
    """Fused attention with the in-kernel edit. q ``(2B, H, P, D)``, k and v
    ``(2B, H, K, D)`` with K = ``spec.key_len`` (unpadded); ``operands`` from
    ``edit_operands`` at the step; q, k, v f32 or bf16. Returns ``(2B, H,
    P, D)`` in q's dtype."""
    two_b, heads, pixels, d = q.shape
    if two_b // 2 < 2:
        raise ValueError(f"edit_attention needs a base row and ≥ 1 edit row "
                         f"in the cond half, got CFG batch {two_b}")
    if k.shape[2] != spec.key_len:
        raise ValueError(f"edit_attention: {k.shape[2]} keys, spec has "
                         f"{spec.key_len}")
    if q.device.type == "cpu":
        return edit_attention_plain(q, k, v, scale, spec, operands)
    if q.device.type != "cuda":
        raise ValueError(f"edit_attention: unsupported device {q.device}")
    if k.shape != (two_b, heads, spec.key_len, d) or v.shape != k.shape:
        raise ValueError(f"edit_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edit_attention: no kernel for {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"edit_attention: {name} must be contiguous "
                             f"{q.dtype} on {q.device}, got {t.dtype} on {t.device}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"edit_attention: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    e, kp = two_b // 2 - 1, spec.pad_len
    transform = _operand(operands, "transform", (e, kp, kp), q.device)
    refine_mix = _operand(operands, "refine_mix", (e, kp), q.device)
    equalizer = _operand(operands, "equalizer", (e, kp), q.device)
    blend = _operand(operands, "blend", (e, kp), q.device)
    if blend is None or (transform is None) == spec.has_transform:
        raise ValueError(f"edit_attention: operands {sorted(operands)} do not "
                         f"match {spec}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    bf16 = q.dtype == torch.bfloat16
    lib, fn = _entry(bf16)
    out = torch.empty_like(q)
    # The fold's workspace, one allocation: V1, V2 (in bf16 as hi/lo pairs:
    # V1, V2, V1 lo, V2 lo), then the (E, 2) int32 flags.
    n = e * heads * spec.key_len * d   # values of V1, of V2
    parts = 4 if bf16 else 2
    size = q.element_size()
    ws = torch.empty(parts * n * size + 8 * e, dtype=torch.uint8, device=q.device)
    at = [ws.data_ptr() + i * size * n for i in range(parts + 1)]
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(transform),
                ptr(refine_mix), ptr(equalizer), blend.data_ptr(), out.data_ptr(),
                *at, two_b, heads, pixels, spec.key_len, d, kp, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "p2p_fused_edit_fwd_bf16" if bf16 else "p2p_fused_edit_fwd")
    if bf16:
        edit_attention.bf16_launches += 1
        edit_attention.bf16_fold_launches += 1
    else:
        edit_attention.launches += 1
        edit_attention.fold_launches += 1
    return out


edit_attention.launches = 0
edit_attention.fold_launches = 0
edit_attention.bf16_launches = 0
edit_attention.bf16_fold_launches = 0


def fused_site_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, controller, meta, step: int
                         ) -> Optional[torch.Tensor]:
    """Site-level entry: the site's spec from the controller, the step's
    operands, the kernel. ``None`` when the site is not kernel-compilable
    (the caller keeps the materialized path), and when the CFG batch has no
    edit row."""
    spec = kernel_edit_spec(controller, meta)
    if spec is None or q.shape[0] // 2 < 2:
        return None
    ops = {name: t.contiguous()
           for name, t in edit_operands(controller.edit, spec, step).items()}
    return edit_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          scale, spec, ops)
