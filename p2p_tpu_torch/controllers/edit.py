"""The cross/self attention edit algebra (Replace / Refine / Reweight).

The PyTorch counterpart of ``p2p_tpu/controllers/edit.py``: functions over
``(heads, P, K)`` base maps and ``(E, heads, P, K)`` edit maps, parameterized
by one :class:`EditParams`. The three edit kinds are one ``kind`` switch plus
an optional equalizer multiply. All arithmetic is f32; the Replace
projection is a full-f32 matmul (TF32 stays off on the port's path, the
counterpart of ``Precision.HIGHEST``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EditParams:
    """Precomputed edit parameters (host-side, once per edit).

    Tensor fields:
      cross_alpha  — ``(T+1, E, 1, 1, L)`` per-step/per-token blend schedule.
      mapper       — Replace: ``(E, L, L)`` float projection; Refine:
                     ``(E, L)`` int64 gather; None for pure Reweight.
      refine_alphas— Refine: ``(E, 1, 1, L)`` 0/1 "token existed in source".
      equalizer    — ``(E, L)`` per-token scales, or None.

    Scalars:
      self_start/end   — step window ``[start, end)`` of self-attention
                         injection.
      kind             — 'replace' | 'refine' | 'none' (base transform).
      self_max_pixels  — inject only into self maps this small.
    """

    cross_alpha: torch.Tensor
    mapper: Optional[torch.Tensor] = None
    refine_alphas: Optional[torch.Tensor] = None
    equalizer: Optional[torch.Tensor] = None
    self_start: int = 0
    self_end: int = 0
    kind: str = "none"
    self_max_pixels: int = 16 * 16

    def to(self, device) -> "EditParams":
        """A copy with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, cross_alpha=mv(self.cross_alpha), mapper=mv(self.mapper),
            refine_alphas=mv(self.refine_alphas), equalizer=mv(self.equalizer))


def base_cross_transform(params: EditParams, attn_base: torch.Tensor,
                         attn_edit: torch.Tensor) -> torch.Tensor:
    """The kind-specific map from the source prompt's attention to candidate
    edit attention, before the time-schedule blend.

    attn_base: (H, P, L); attn_edit: (E, H, P, L); returns (E, H, P, L).
    """
    if params.kind == "replace":
        # Project source token columns through the (L, L) word-swap matrix.
        return torch.einsum("hpw,ewn->ehpn", attn_base, params.mapper)
    if params.kind == "refine":
        # Gather source columns at mapper positions and blend by per-token
        # alphas; -1 entries (tokens new in the edit prompt) wrap to the last
        # column but carry alpha 0.
        idx = params.mapper % attn_base.shape[-1]                   # (E, L)
        gathered = attn_base[:, :, idx]                             # (H, P, E, L)
        gathered = gathered.movedim(2, 0)                           # (E, H, P, L)
        ra = params.refine_alphas
        return gathered * ra + attn_edit * (1.0 - ra)
    if params.kind == "none":
        return attn_base[None].expand(attn_edit.shape)
    raise ValueError(f"unknown edit kind: {params.kind!r}")


def edit_cross_attention(params: EditParams, attn_base: torch.Tensor,
                         attn_edit: torch.Tensor, step: int) -> torch.Tensor:
    """Full cross-attention edit: base transform, optional equalizer scaling
    (Reweight leaves rows unnormalized, as the reference does), then the
    per-step/per-token schedule blend."""
    new = base_cross_transform(params, attn_base, attn_edit)
    if params.equalizer is not None:
        new = new * params.equalizer[:, None, None, :]
    alpha = params.cross_alpha[step]                # (E, 1, 1, L)
    return new * alpha + (1.0 - alpha) * attn_edit


def edit_self_attention(params: EditParams, attn_base: torch.Tensor,
                        attn_edit: torch.Tensor, step: int,
                        pixels: int) -> torch.Tensor:
    """Self-attention injection: inside the ``[self_start, self_end)`` step
    window, maps with ≤ ``self_max_pixels`` query pixels are overwritten by
    the source prompt's maps."""
    if pixels > params.self_max_pixels:
        return attn_edit
    if params.self_start <= step < params.self_end:
        return attn_base[None].expand(attn_edit.shape)
    return attn_edit
