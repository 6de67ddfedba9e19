"""KL autoencoder decode — the PyTorch counterpart of the decode half of
``p2p_tpu/models/vae.py``.

``decode`` takes latents ``(B, h, w, 4)`` (NHWC, as the JAX package) to an
image ``(B, H, W, 3)`` in [-1, 1]; inside it runs NCHW. The mid block's
single-head self-attention over all pixels (S = 4096, d = 512 at SD-1.4's
64² latent) is the flash kernel K1.
"""

from __future__ import annotations

import torch

from . import nn
from .checkpoint import StateDict
from .config import VAEConfig


def _apply_resnet(sd: StateDict, p: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = nn.conv2d(nn.silu(nn.group_norm(x, sd[p + ".norm1.weight"],
                                        sd[p + ".norm1.bias"], groups)),
                  sd[p + ".conv1.weight"], sd[p + ".conv1.bias"])
    h = nn.conv2d(nn.silu(nn.group_norm(h, sd[p + ".norm2.weight"],
                                        sd[p + ".norm2.bias"], groups)),
                  sd[p + ".conv2.weight"], sd[p + ".conv2.bias"])
    if p + ".conv_shortcut.weight" in sd:
        x = nn.conv2d(x, sd[p + ".conv_shortcut.weight"], sd[p + ".conv_shortcut.bias"])
    return x + h


def _apply_attn(sd: StateDict, p: str, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head full self-attention over pixels (the mid block's)."""
    b, c, hh, ww = x.shape
    y = nn.group_norm(x, sd[p + ".group_norm.weight"], sd[p + ".group_norm.bias"],
                      groups)
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)

    def lin(name, t):
        return nn.linear(t, sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"])

    q, k, v = (lin(n, y)[:, None] for n in ("query", "key", "value"))
    out = nn.fused_attention(q, k, v, c ** -0.5)[:, 0]
    out = lin("proj_attn", out).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return x + out


def decode(sd: StateDict, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, h, w, 4) → image (B, H, W, 3) in [-1, 1], the input
    scaled by 1 / ``scaling_factor`` first."""
    if cfg.kind != "kl":
        raise NotImplementedError(f"VAE kind {cfg.kind!r} is not ported to "
                                  "p2p_tpu_torch")
    g = cfg.groups
    h = (latents / cfg.scaling_factor).permute(0, 3, 1, 2)
    h = nn.conv2d(h, sd["post_quant_conv.weight"], sd["post_quant_conv.bias"])
    h = nn.conv2d(h, sd["decoder.conv_in.weight"], sd["decoder.conv_in.bias"])
    h = _apply_resnet(sd, "decoder.mid_block.resnets.0", h, g)
    h = _apply_attn(sd, "decoder.mid_block.attentions.0", h, g)
    h = _apply_resnet(sd, "decoder.mid_block.resnets.1", h, g)
    for pos in range(len(cfg.channel_mults)):
        for j in range(cfg.layers_per_block + 1):
            h = _apply_resnet(sd, f"decoder.up_blocks.{pos}.resnets.{j}", h, g)
        up = f"decoder.up_blocks.{pos}.upsamplers.0.conv"
        if up + ".weight" in sd:
            h = nn.conv2d(nn.upsample_nearest_2x(h), sd[up + ".weight"],
                          sd[up + ".bias"])
    h = nn.silu(nn.group_norm(h, sd["decoder.conv_norm_out.weight"],
                              sd["decoder.conv_norm_out.bias"], g))
    h = nn.conv2d(h, sd["decoder.conv_out.weight"], sd["decoder.conv_out.bias"])
    return h.permute(0, 2, 3, 1)


def to_uint8(image: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float → uint8 (truncating, as the JAX package's astype)."""
    return ((image / 2 + 0.5).clamp(0.0, 1.0) * 255).to(torch.uint8)
