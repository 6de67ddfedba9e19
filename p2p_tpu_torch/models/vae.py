"""KL autoencoder — the PyTorch counterpart of ``p2p_tpu/models/vae.py``.

``decode`` takes latents ``(B, h, w, 4)`` (NHWC, as the JAX package) to an
image ``(B, H, W, 3)`` in [-1, 1]; ``encode`` / ``encode_moments`` take an
image back to latents (null-text inversion's starting point); inside both
run NCHW. The mid blocks' single-head self-attention over all pixels
(S = 4096, d = 512 at SD-1.4's 64² latent) is the flash kernel K1.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

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


def _check_kind(cfg: VAEConfig) -> None:
    if cfg.kind != "kl":
        raise NotImplementedError(f"VAE kind {cfg.kind!r} is not ported to "
                                  "p2p_tpu_torch")


def _encoder_trunk(sd: StateDict, cfg: VAEConfig, image: torch.Tensor) -> torch.Tensor:
    """image (B, H, W, 3) → quant_conv output, NCHW: conv_in → down blocks
    (diffusers' asymmetric pad of one row and one column, bottom and right,
    before each stride-2 conv) → mid → norm/conv_out → quant_conv."""
    g = cfg.groups
    h = nn.conv2d(image.permute(0, 3, 1, 2), sd["encoder.conv_in.weight"],
                  sd["encoder.conv_in.bias"])
    for lvl in range(len(cfg.channel_mults)):
        for j in range(cfg.layers_per_block):
            h = _apply_resnet(sd, f"encoder.down_blocks.{lvl}.resnets.{j}", h, g)
        down = f"encoder.down_blocks.{lvl}.downsamplers.0.conv"
        if down + ".weight" in sd:
            h = nn.conv2d(F.pad(h, (0, 1, 0, 1)), sd[down + ".weight"],
                          sd[down + ".bias"], stride=2, padding=0)
    h = _apply_resnet(sd, "encoder.mid_block.resnets.0", h, g)
    h = _apply_attn(sd, "encoder.mid_block.attentions.0", h, g)
    h = _apply_resnet(sd, "encoder.mid_block.resnets.1", h, g)
    h = nn.silu(nn.group_norm(h, sd["encoder.conv_norm_out.weight"],
                              sd["encoder.conv_norm_out.bias"], g))
    h = nn.conv2d(h, sd["encoder.conv_out.weight"], sd["encoder.conv_out.bias"])
    return nn.conv2d(h, sd["quant_conv.weight"], sd["quant_conv.bias"])


def encode_moments(sd: StateDict, cfg: VAEConfig, image: torch.Tensor):
    """image (B, H, W, 3) in [-1, 1] → the posterior's ``(mean, logvar)``,
    each ``(B, H/8, W/8, latent_channels)`` (NHWC), logvar clipped to
    [-30, 20]."""
    _check_kind(cfg)
    mean, logvar = _encoder_trunk(sd, cfg, image).permute(0, 2, 3, 1).chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode(sd: StateDict, cfg: VAEConfig, image: torch.Tensor) -> torch.Tensor:
    """Deterministic latent: the posterior mean times ``scaling_factor``."""
    mean, _ = encode_moments(sd, cfg, image)
    return mean * cfg.scaling_factor


def decode(sd: StateDict, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, h, w, 4) → image (B, H, W, 3) in [-1, 1], the input
    scaled by 1 / ``scaling_factor`` first."""
    _check_kind(cfg)
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
