"""LocalBlend — spatial masking of edits from stored cross-attention maps.

The PyTorch counterpart of ``p2p_tpu/controllers/blend.py``: the null-text
variant of the reference's LocalBlend (a ``start_blend`` warm-up,
``substruct_words`` and two thresholds), whose ``mask[:1] | mask`` form is
general in the batch size. Latents are NHWC ``(B, H, W, C)``; the mask is
computed at the blend resolution (16×16 for SD-1.4) from every stored cross
site at that resolution (``AttnLayout.blend_metas``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import torch
import torch.nn.functional as F

if TYPE_CHECKING:
    from .base import AttnLayout


@dataclasses.dataclass(frozen=True)
class BlendParams:
    """Precomputed LocalBlend parameters.

    ``alpha_layers`` / ``substruct_layers``: ``(B, L)`` f32 one-hot over the
    selected words' token positions per prompt (B = 1 + E, the source
    prompt included). ``start_blend`` is a step count: blending starts once
    ``step + 1 > start_blend``. ``resolution`` selects the stored maps."""

    alpha_layers: torch.Tensor
    substruct_layers: Optional[torch.Tensor] = None
    start_blend: int = 0
    th_pool: float = 0.3
    th_nopool: float = 0.3
    resolution: int = 16

    def to(self, device) -> "BlendParams":
        """A copy with every tensor on ``device``."""
        sub = self.substruct_layers
        return dataclasses.replace(
            self, alpha_layers=self.alpha_layers.to(device),
            substruct_layers=None if sub is None else sub.to(device))


def _max_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3, stride-1, pad-1 max pool over the two trailing axes of
    ``(B, H, W)``; the padding never wins the max."""
    return F.max_pool2d(x[:, None], kernel_size=3, stride=1, padding=1)[:, 0]


def _resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of the two trailing axes with half-pixel
    centres, source index ``floor((i + 0.5)·in/out)`` in f32 — the rule of
    ``jax.image.resize(..., method="nearest")``."""
    for axis, n in zip((-2, -1), out_hw):
        m = x.shape[axis]
        if m == n:
            continue
        idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device)
                           + 0.5) * m / n).long()
        x = x.index_select(x.dim() + axis, idx)
    return x


def _collect_blend_maps(params: BlendParams, layout: "AttnLayout",
                        state: tuple) -> torch.Tensor:
    """The accumulated cross maps at the blend resolution, stacked as
    ``(B, sites·heads, res, res, L)``."""
    res = params.resolution
    maps = []
    for m in layout.blend_metas(res):
        a = state[m.store_slot]  # (B, heads, res², L)
        maps.append(a.reshape(a.shape[0], a.shape[1], res, res, a.shape[-1]))
    if not maps:
        raise ValueError(
            f"LocalBlend needs stored cross-attention maps at resolution {res} "
            "— check the layout's StoreConfig stores cross maps.")
    return torch.cat(maps, dim=1)


def _mask_from_maps(maps: torch.Tensor, word_alpha: torch.Tensor,
                    use_pool: bool, threshold: float, out_hw) -> torch.Tensor:
    """Word-weighted average → (pool) → upsample → per-image max-normalize
    → threshold → OR with the source image's mask. Returns bool
    ``(B, H, W)``."""
    weighted = (maps * word_alpha[:, None, None, None, :]).sum(-1).mean(1)
    if use_pool:
        weighted = _max_pool_3x3(weighted)
    mask = _resize_nearest(weighted, out_hw)
    denom = mask.amax(dim=(1, 2), keepdim=True)
    mask = mask / denom.clamp_min(1e-20)
    mask = mask > threshold
    return mask[:1] | mask


def apply_local_blend(params: BlendParams, layout: "AttnLayout", state: tuple,
                      x_t: torch.Tensor, step: int) -> torch.Tensor:
    """Composite the edited latents onto the source latents outside the
    mask, ``x_t[:1] + mask·(x_t − x_t[:1])``, once ``step + 1 >
    start_blend``. ``x_t``: NHWC ``(B, H, W, C)``."""
    if step + 1 <= params.start_blend:
        return x_t
    maps = _collect_blend_maps(params, layout, state)
    hw = (x_t.shape[1], x_t.shape[2])
    mask = _mask_from_maps(maps, params.alpha_layers, True, params.th_pool, hw)
    if params.substruct_layers is not None:
        sub = _mask_from_maps(maps, params.substruct_layers, False,
                              params.th_nopool, hw)
        mask = mask & ~sub
    maskf = mask.to(x_t.dtype)[..., None]  # (B, H, W, 1)
    return x_t[:1] + maskf * (x_t - x_t[:1])
