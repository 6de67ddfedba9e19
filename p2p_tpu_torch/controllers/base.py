"""Functional attention-controller core.

The PyTorch counterpart of ``p2p_tpu/controllers/base.py``. A controller is
a pure function from (attention probabilities, site, step) to attention
probabilities, plus a latent post-step hook, with every edit parameter
precomputed host-side:

- **Site position is static.** Each attention call site of the U-Net has an
  :class:`AttnMeta` (place / is_cross / resolution / store slot), built once
  from the config; no module is patched at run time.
- **The step index is an argument** of every hook.
- **The store is a tuple of fixed-shape tensors** (one per stored site),
  accumulated by addition across steps and returned explicitly.

Attention tensors have shape ``(2B, heads, P, K)``: the classifier-free
guidance batch ``[uncond(B); cond(B)]`` with ``B = 1 + E`` (source prompt +
E edit prompts). Edits touch only rows ``1:`` of the conditional half.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .blend import BlendParams, apply_local_blend
from .edit import EditParams, edit_cross_attention, edit_self_attention


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    """Static description of one attention call site inside the U-Net."""

    layer_idx: int          # global index over all attention call sites
    place: str              # 'down' | 'mid' | 'up'
    is_cross: bool
    resolution: int         # spatial side length of the feature map
    heads: int
    key_len: int            # K (context length for cross, pixels for self)
    store_slot: Optional[int] = None  # index into the store state, or None
    channels: int = 0       # feature-map width at this site

    @property
    def pixels(self) -> int:
        return self.resolution * self.resolution


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """What the attention store keeps: maps of at most ``max_pixels`` query
    pixels, cross and/or self."""

    max_pixels: int = 32 * 32
    store_cross: bool = True
    store_self: bool = True

    def wants(self, meta: AttnMeta) -> bool:
        if meta.pixels > self.max_pixels:
            return False
        return self.store_cross if meta.is_cross else self.store_self


@dataclasses.dataclass(frozen=True)
class AttnLayout:
    """The full static attention structure of a model: one AttnMeta per call
    site, with store slots assigned."""

    metas: Tuple[AttnMeta, ...]
    store_cfg: StoreConfig

    @property
    def num_store_slots(self) -> int:
        return sum(1 for m in self.metas if m.store_slot is not None)

    def stored_metas(self) -> Tuple[AttnMeta, ...]:
        return tuple(m for m in self.metas if m.store_slot is not None)

    def blend_metas(self, resolution: int = 16) -> Tuple[AttnMeta, ...]:
        """The stored cross sites at ``resolution``: the maps LocalBlend
        reads (for SD-1.4 the reference's ``down_cross[2:4] +
        up_cross[:3]``)."""
        return tuple(m for m in self.metas
                     if m.is_cross and m.resolution == resolution
                     and m.store_slot is not None)


def build_layout(specs: Sequence[Tuple],
                 store_cfg: StoreConfig = StoreConfig()) -> AttnLayout:
    """Assemble an :class:`AttnLayout` from ``(place, is_cross, resolution,
    heads, key_len[, channels])`` tuples in call order, assigning store slots
    to the sites the :class:`StoreConfig` wants."""
    metas = []
    slot = 0
    for idx, spec in enumerate(specs):
        place, is_cross, resolution, heads, key_len = spec[:5]
        channels = spec[5] if len(spec) > 5 else 0
        meta = AttnMeta(idx, place, is_cross, resolution, heads, key_len,
                        channels=channels)
        if store_cfg.wants(meta):
            meta = dataclasses.replace(meta, store_slot=slot)
            slot += 1
        metas.append(meta)
    return AttnLayout(tuple(metas), store_cfg)


@dataclasses.dataclass(frozen=True)
class Controller:
    """A prompt-to-prompt controller.

    The all-None controller is the identity (EmptyControl); ``store=True``
    alone is AttentionStore; ``blend`` (LocalBlend) composites latents from
    the stored cross maps after every step, so it needs the store as
    ``store`` does. ``spatial_stop_inject`` (SpatialReplace) is not ported
    yet: the latent hook raises when it meets it.
    """

    edit: Optional[EditParams] = None
    blend: Optional[BlendParams] = None
    spatial_stop_inject: Optional[int] = None
    store: bool = False

    @property
    def is_identity(self) -> bool:
        return (self.edit is None and self.blend is None and not self.store
                and self.spatial_stop_inject is None)

    @property
    def needs_store(self) -> bool:
        return self.store or self.blend is not None

    def to(self, device) -> "Controller":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(
            self, edit=None if self.edit is None else self.edit.to(device),
            blend=None if self.blend is None else self.blend.to(device))


def controller_touches(controller: Optional[Controller], meta: AttnMeta) -> bool:
    """Does this controller ever read or write this site's attention
    probabilities? Sites where this is False run plain fused attention and
    their probability tensor never exists."""
    if controller is None or controller.is_identity:
        return False
    if meta.store_slot is not None and controller.needs_store:
        return True
    if controller.edit is not None:
        if meta.is_cross:
            return True
        return meta.pixels <= controller.edit.self_max_pixels
    return False


StoreState = Tuple[torch.Tensor, ...]


def init_store_state(layout: AttnLayout, batch_cond: int,
                     dtype=torch.float32, device=None) -> StoreState:
    """Zero-initialized accumulation buffers, one per stored call site:
    ``(B_cond, heads, pixels, key_len)`` each."""
    return tuple(
        torch.zeros((batch_cond, m.heads, m.pixels, m.key_len), dtype=dtype,
                    device=device)
        for m in layout.stored_metas()
    )


def apply_attention_control(controller: Optional[Controller], meta: AttnMeta,
                            state: StoreState, attn: torch.Tensor, step: int
                            ) -> Tuple[StoreState, torch.Tensor]:
    """The per-site hook: edit the conditional half, then store the
    *post-edit* maps (what the reference's store observes, since it appends
    the conditional tensor by reference and edits it in place afterwards).

    ``attn``: softmax probabilities, shape ``(2B, heads, P, K)``."""
    if controller is None or controller.is_identity:
        return state, attn

    b = attn.shape[0] // 2
    cond = attn[b:]

    if controller.edit is not None and b > 1:
        base, edits = cond[0], cond[1:]
        if meta.is_cross:
            new_edits = edit_cross_attention(controller.edit, base, edits, step)
        else:
            new_edits = edit_self_attention(controller.edit, base, edits, step,
                                            meta.pixels)
        cond = torch.cat([base[None], new_edits.to(attn.dtype)], dim=0)
        attn = torch.cat([attn[:b], cond], dim=0)

    if meta.store_slot is not None and controller.needs_store:
        lst = list(state)
        lst[meta.store_slot] = lst[meta.store_slot] + cond.to(lst[meta.store_slot].dtype)
        state = tuple(lst)

    return state, attn


def apply_step_callback(controller: Optional[Controller], layout: AttnLayout,
                        state: StoreState, x_t: torch.Tensor, step: int
                        ) -> torch.Tensor:
    """Post-scheduler-step latent hook: LocalBlend compositing. SpatialReplace
    injection is not ported yet and raises."""
    if controller is None or controller.is_identity:
        return x_t
    if controller.spatial_stop_inject is not None:
        raise NotImplementedError("SpatialReplace is not ported to p2p_tpu_torch yet")
    if controller.blend is not None:
        x_t = apply_local_blend(controller.blend, layout, state, x_t, step)
    return x_t
