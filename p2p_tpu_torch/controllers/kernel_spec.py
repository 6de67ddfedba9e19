"""Kernel-compilable edit specs: the controller, lowered for the fused-edit
kernel.

The PyTorch counterpart of ``p2p_tpu/controllers/kernel_spec.py``. The edit
algebra of :mod:`controllers.edit` works on whole ``(E, heads, P, K)``
probability tensors; the fused kernel sees one query row at a time, so the
per-site edit is restated as row-local operations along the key axis:

- **Static spec** (:class:`EditSpec`, from :func:`kernel_edit_spec`): edit
  kind, equalizer presence, key geometry. ``None`` means the site keeps the
  materialized path.
- **Operands** (:func:`edit_operands`): per-edit-row f32 tensors, key axis
  padded to ``pad_len`` exactly as the JAX package pads them:

  ``transform`` (E, Kp, Kp)  Replace's word-swap matrix, or Refine's gather
                             as a one-hot matmul
  ``refine_mix`` (E, Kp)     Refine's per-token source/edit blend ``ra``
  ``equalizer``  (E, Kp)     Reweight's per-key-token scale
  ``blend``      (E, Kp)     the step's schedule blend α (cross sites), or
                             the 0/1 injection-window predicate (self sites)

  With them every edit family is one formula over a probability row
  (``probs`` = the edit row's own softmax, ``base`` = the source row)::

      t      = base @ M                      (skipped when kind == 'none')
      new    = t·ra + probs·(1 − ra)         (ra ≡ 1 except Refine)
      new    = new · equalizer
      edited = new·α + (1 − α)·probs

Sites whose post-edit maps feed the attention store stay materialized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .base import AttnMeta, Controller, controller_touches
from .edit import EditParams

#: The key axis of the operands is padded to a multiple of this (the JAX
#: package's TPU lane width; kept so operands compare shape for shape).
LANE = 128


def padded_key_len(key_len: int) -> int:
    return max(LANE, ((key_len + LANE - 1) // LANE) * LANE)


@dataclasses.dataclass(frozen=True)
class EditSpec:
    """Static (hashable) description of one site's in-kernel edit program."""

    kind: str            # 'replace' | 'refine' | 'none'
    is_cross: bool
    has_equalizer: bool
    key_len: int         # unpadded K (context_len for cross, pixels for self)
    pad_len: int         # K padded to the lane multiple

    @property
    def has_transform(self) -> bool:
        return self.kind in ("replace", "refine")


def kernel_edit_spec(controller: Optional[Controller],
                     meta: AttnMeta) -> Optional[EditSpec]:
    """The site's :class:`EditSpec`, or ``None`` if the fused kernel cannot
    express what the controller does there: it must *edit* the site (cross
    always; self within ``self_max_pixels``) and must not store its maps."""
    if controller is None or controller.is_identity or controller.edit is None:
        return None
    if not controller_touches(controller, meta):
        return None
    if meta.store_slot is not None and controller.needs_store:
        return None
    if not meta.is_cross and meta.pixels > controller.edit.self_max_pixels:
        return None
    edit = controller.edit
    kind = edit.kind if meta.is_cross else "none"
    return EditSpec(
        kind=kind,
        is_cross=meta.is_cross,
        has_equalizer=meta.is_cross and edit.equalizer is not None,
        key_len=meta.key_len,
        pad_len=padded_key_len(meta.key_len),
    )


def edit_operands(params: EditParams, spec: EditSpec, step: int) -> dict:
    """The kernel's per-edit-row operand tensors for one site at one step,
    on the device of ``params``. All f32, key axis padded to
    ``spec.pad_len``; entries not used by ``spec.kind`` are omitted."""
    num_edits = params.cross_alpha.shape[1]
    kp = spec.pad_len
    device = params.cross_alpha.device
    ops: dict = {}

    if spec.is_cross:
        k = spec.key_len
        alpha = params.cross_alpha[step].reshape(num_edits, k).float()
        ops["blend"] = F.pad(alpha, (0, kp - k))
        if spec.kind == "replace":
            m = params.mapper.float()                           # (E, K, K)
            ops["transform"] = F.pad(m, (0, kp - k, 0, kp - k))
        elif spec.kind == "refine":
            # gathered[..., n] = base[..., mapper[e, n]]  ⇔  base @ M with
            # M[w, n] = [w == mapper[e, n]]; -1 entries wrap to the last
            # column and carry refine_alpha 0.
            idx = params.mapper % k                             # (E, K)
            onehot = (torch.arange(kp, device=device)[None, :, None]
                      == idx[:, None, :]).float()               # (E, Kp, K)
            ops["transform"] = F.pad(onehot, (0, kp - k))
            ra = params.refine_alphas.reshape(num_edits, k).float()
            ops["refine_mix"] = F.pad(ra, (0, kp - k))
        if spec.has_equalizer:
            eq = params.equalizer.float()                       # (E, K)
            ops["equalizer"] = F.pad(eq, (0, kp - k), value=1.0)
    else:
        # Self-attention injection: inside the window the edit rows' maps
        # are the base row's maps, an α-blend with α = [in window].
        in_window = params.self_start <= step < params.self_end
        ops["blend"] = torch.full((num_edits, kp), float(in_window),
                                  dtype=torch.float32, device=device)
    return ops
