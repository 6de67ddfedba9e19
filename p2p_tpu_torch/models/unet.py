"""Conditional U-Net with the controller hook at every attention site — the
PyTorch counterpart of ``p2p_tpu/models/unet.py`` (the ungated forward).

Topology: diffusers' ``UNet2DConditionModel`` as configured for SD-1.4,
conv_in → attentive down blocks → mid → attentive up blocks with skip
concats → conv_out. Every transformer block holds a self and a cross
attention site, each with a static ``AttnMeta`` from the layout; a site runs
one of three branches:

- **fused-edit** — a ``KernelConfig`` covers the site and the controller's
  edit there is kernel-compilable: K2 (``kernels.fused_edit``);
- **materialized** — the controller touches the site otherwise: f32
  probabilities through ``apply_attention_control``, then ``probs @ v``;
- **untouched** — ``nn.fused_attention`` (K1 at the 64²-pixel self sites).

Latents are NHWC at the boundary, NCHW inside; weights come from a
diffusers-named state dict (``models.checkpoint``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..controllers.base import (
    AttnLayout,
    Controller,
    StoreState,
    apply_attention_control,
    controller_touches,
)
from . import nn
from .checkpoint import StateDict
from .config import UNetConfig, unet_layout


class _HookCtx:
    """Cursor over the attention layout, carrying the controller store
    state through the sites in call order."""

    def __init__(self, layout: AttnLayout, controller: Optional[Controller],
                 state: StoreState, step: int, kernels):
        self.layout = layout
        self.controller = controller
        self.state = state
        self.step = step
        self.kernels = kernels
        self.cursor = 0

    def next_meta(self):
        meta = self.layout.metas[self.cursor]
        self.cursor += 1
        return meta


def _lin(sd: StateDict, name: str, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(x, sd[name + ".weight"], sd.get(name + ".bias"))


def _apply_resnet(sd: StateDict, p: str, x: torch.Tensor, temb: torch.Tensor,
                  groups: int) -> torch.Tensor:
    h = nn.conv2d(nn.silu(nn.group_norm(x, sd[p + ".norm1.weight"],
                                        sd[p + ".norm1.bias"], groups)),
                  sd[p + ".conv1.weight"], sd[p + ".conv1.bias"])
    h = h + _lin(sd, p + ".time_emb_proj", nn.silu(temb))[:, :, None, None]
    h = nn.conv2d(nn.silu(nn.group_norm(h, sd[p + ".norm2.weight"],
                                        sd[p + ".norm2.bias"], groups)),
                  sd[p + ".conv2.weight"], sd[p + ".conv2.bias"])
    if p + ".conv_shortcut.weight" in sd:
        x = nn.conv2d(x, sd[p + ".conv_shortcut.weight"], sd[p + ".conv_shortcut.bias"])
    return x + h


def _fused_edit_dispatch(ctx: _HookCtx, meta, q, k, v, scale):
    """K2 at a covered controller-touched site; ``None`` keeps the
    materialized path (no config, an uncovered site, a store site, or a
    CFG batch without edit rows)."""
    if ctx.kernels is None:
        return None
    from ..kernels.dispatch import site_name
    from ..kernels.fused_edit import fused_site_attention

    if not ctx.kernels.covers(site_name(meta)):
        return None
    return fused_site_attention(q, k, v, scale, ctx.controller, meta, ctx.step)


def _apply_attention(sd: StateDict, p: str, x: torch.Tensor,
                     context: torch.Tensor, heads: int, ctx: _HookCtx,
                     is_cross: bool) -> torch.Tensor:
    """One attention site. x: (B, P, C); context: (B, K, Cc)."""
    meta = ctx.next_meta()
    assert meta.is_cross == is_cross, (
        f"layout order mismatch at site {meta.layer_idx}: layout says "
        f"is_cross={meta.is_cross}, model called is_cross={is_cross}")
    b, pix, _ = x.shape
    src = context if is_cross else x
    q = _lin(sd, p + ".to_q", x)
    k = _lin(sd, p + ".to_k", src)
    v = _lin(sd, p + ".to_v", src)
    d_head = q.shape[-1] // heads
    scale = d_head ** -0.5

    def split_heads(t):
        return t.reshape(b, t.shape[1], heads, d_head).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)

    if controller_touches(ctx.controller, meta):
        out = _fused_edit_dispatch(ctx, meta, q, k, v, scale)
        if out is None:
            probs = nn.attention_probs(q, k, scale)       # (B, heads, P, K) f32
            ctx.state, probs = apply_attention_control(
                ctx.controller, meta, ctx.state, probs, ctx.step)
            out = nn.probs_value(probs, v)
    else:
        out = nn.fused_attention(q, k, v, scale)

    out = out.transpose(1, 2).reshape(b, pix, heads * d_head)
    return _lin(sd, p + ".to_out.0", out)


def _apply_transformer_block(sd: StateDict, p: str, x: torch.Tensor,
                             context: torch.Tensor, heads: int,
                             ctx: _HookCtx) -> torch.Tensor:
    def ln(name, t):
        return nn.layer_norm(t, sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"])

    x = nn.add(x, _apply_attention(sd, p + ".attn1", ln("norm1", x), context,
                                   heads, ctx, is_cross=False))
    x = nn.add(x, _apply_attention(sd, p + ".attn2", ln("norm2", x), context,
                                   heads, ctx, is_cross=True))
    h = _lin(sd, p + ".ff.net.0.proj", ln("norm3", x))
    val, gate = h.chunk(2, dim=-1)
    return nn.add(x, _lin(sd, p + ".ff.net.2", val * nn.gelu(gate)))


def _apply_spatial_transformer(sd: StateDict, p: str, x: torch.Tensor,
                               context: torch.Tensor, cfg: UNetConfig,
                               ctx: _HookCtx) -> torch.Tensor:
    b, c, hh, ww = x.shape
    residual = x
    x = nn.group_norm(x, sd[p + ".norm.weight"], sd[p + ".norm.bias"],
                      cfg.groups, eps=1e-6)
    # proj_in / proj_out are 1x1 convs, applied as linears on (B, P, C)
    # tokens so the transformer stack stays token-major.
    x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    x = nn.linear(x, sd[p + ".proj_in.weight"][:, :, 0, 0], sd[p + ".proj_in.bias"])
    for d in range(cfg.transformer_depth):
        x = _apply_transformer_block(sd, f"{p}.transformer_blocks.{d}", x,
                                     context, cfg.heads_for(c), ctx)
    x = nn.linear(x, sd[p + ".proj_out.weight"][:, :, 0, 0], sd[p + ".proj_out.bias"])
    return x.reshape(b, hh, ww, c).permute(0, 3, 1, 2) + residual


def apply_unet(
    sd: StateDict,
    cfg: UNetConfig,
    x: torch.Tensor,                  # (B, H, W, C) latents, NHWC
    t,                                # int, scalar or (B,) timestep
    context: torch.Tensor,            # (B, K, Cc) text embeddings
    layout: Optional[AttnLayout] = None,
    controller: Optional[Controller] = None,
    state: StoreState = (),
    step: int = 0,
    kernels=None,
    cache_mode: str = "off",
    site_plan: Optional[Tuple[str, ...]] = None,
    sp=None,
) -> Tuple[torch.Tensor, StoreState]:
    """Predict ε(x_t, t, context) as ``(B, H, W, C)``. Returns
    ``(eps, store_state)``.

    ``kernels`` (a ``kernels.KernelConfig``) routes covered, kernel-
    compilable controller-touched sites to K2; ``None`` keeps them
    materialized. ``controller`` must hold its tensors on ``x``'s device
    (``Controller.to``). The reference's phase-gated sampling and
    sequence-parallel options (``cache_mode``, ``site_plan``, ``sp``) are not
    ported yet and raise unless left at their defaults."""
    if cache_mode != "off" or site_plan is not None or sp is not None:
        raise NotImplementedError("cache_mode / site_plan / sp are not ported "
                                  "to p2p_tpu_torch yet")
    if layout is None:
        layout = unet_layout(cfg)
    ctx = _HookCtx(layout, controller, state, step, kernels)
    g = cfg.groups
    ch = cfg.block_channels

    t = torch.as_tensor(t, device=x.device).expand(x.shape[0])
    temb = nn.timestep_embedding(t, cfg.freq_dim or ch[0], dtype=x.dtype)
    temb = _lin(sd, "time_embedding.linear_2",
                nn.silu(_lin(sd, "time_embedding.linear_1", temb)))

    h = nn.conv2d(x.permute(0, 3, 1, 2), sd["conv_in.weight"], sd["conv_in.bias"])
    skips = [h]
    for lvl in range(cfg.levels):
        for j in range(cfg.layers_per_block):
            h = _apply_resnet(sd, f"down_blocks.{lvl}.resnets.{j}", h, temb, g)
            if cfg.attn_levels[lvl]:
                h = _apply_spatial_transformer(
                    sd, f"down_blocks.{lvl}.attentions.{j}", h, context, cfg, ctx)
            skips.append(h)
        if lvl != cfg.levels - 1:
            # Symmetric pad of 1 (diffusers downsample_padding=1).
            down = f"down_blocks.{lvl}.downsamplers.0.conv"
            h = nn.conv2d(h, sd[down + ".weight"], sd[down + ".bias"], stride=2,
                          padding=1)
            skips.append(h)

    h = _apply_resnet(sd, "mid_block.resnets.0", h, temb, g)
    h = _apply_spatial_transformer(sd, "mid_block.attentions.0", h, context, cfg, ctx)
    h = _apply_resnet(sd, "mid_block.resnets.1", h, temb, g)

    for pos, lvl in enumerate(reversed(range(cfg.levels))):
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _apply_resnet(sd, f"up_blocks.{pos}.resnets.{j}", h, temb, g)
            if cfg.attn_levels[lvl]:
                h = _apply_spatial_transformer(
                    sd, f"up_blocks.{pos}.attentions.{j}", h, context, cfg, ctx)
        if lvl != 0:
            up = f"up_blocks.{pos}.upsamplers.0.conv"
            h = nn.conv2d(nn.upsample_nearest_2x(h), sd[up + ".weight"],
                          sd[up + ".bias"])

    assert ctx.cursor == len(layout.metas), (
        f"attention layout mismatch: model has {ctx.cursor} sites, "
        f"layout has {len(layout.metas)}")

    h = nn.silu(nn.group_norm(h, sd["conv_norm_out.weight"],
                              sd["conv_norm_out.bias"], g))
    eps = nn.conv2d(h, sd["conv_out.weight"], sd["conv_out.bias"])
    return eps.permute(0, 2, 3, 1), ctx.state
