"""Model stack: CLIP text encoder, conditional U-Net and KL-VAE decoder as
functions on diffusers-named state dicts."""

from .config import (
    SD14,
    TINY,
    PipelineConfig,
    TextEncoderConfig,
    UNetConfig,
    VAEConfig,
    unet_attn_specs,
    unet_layout,
)
from .text_encoder import apply_text_encoder
from .unet import apply_unet
from . import vae

__all__ = [
    "SD14", "TINY", "PipelineConfig", "TextEncoderConfig", "UNetConfig",
    "VAEConfig", "unet_attn_specs", "unet_layout", "apply_text_encoder",
    "apply_unet", "vae",
]
