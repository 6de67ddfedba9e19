"""Model configurations and static attention-layout derivation.

A jax-free copy of the slice of ``p2p_tpu/models/config.py`` the port runs:
the SD-1.4, SD-2.1 (768-v and 512-base), LDM-256 and TINY configs,
:func:`unet_attn_specs` and :func:`unet_layout`. The attention structure is a pure function of the
config: :func:`unet_attn_specs` enumerates every attention call site (place,
kind, resolution, heads, key length) in exact call order and feeds
``controllers.base.build_layout``. ``tests/test_torch_copies.py`` holds the
copy equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..controllers.base import AttnLayout, StoreConfig, build_layout


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Shape config for the conditional U-Net (diffusers
    `UNet2DConditionModel` topology, e.g. SD-v1.4's 32 attention sites)."""

    sample_size: int = 64                  # latent side length
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # True → the down/up block at this level carries transformer blocks.
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    num_heads: int = 8
    # When set, heads vary per level as channels // head_dim (LDM's fixed
    # per-head width); when None, num_heads applies uniformly (SD).
    head_dim: Optional[int] = None
    context_dim: int = 768                 # text-encoder hidden size
    context_len: int = 77
    transformer_depth: int = 1             # transformer blocks per attn site group
    groups: int = 32
    ff_mult: int = 4
    freq_dim: Optional[int] = None         # sinusoidal dim; default block_channels[0]

    @property
    def time_embed_dim(self) -> int:
        return self.block_channels[0] * 4

    @property
    def levels(self) -> int:
        return len(self.block_channels)

    def resolution_at(self, level: int) -> int:
        return self.sample_size >> level

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            assert channels % self.head_dim == 0, (channels, self.head_dim)
            return channels // self.head_dim
        return self.num_heads


SD14_UNET = UNetConfig()

# Tiny config for tests: same topology class (2 of 3 levels attentive, mid
# attention, skip concats, CFG) at ~1/4000 the parameters.
TINY_UNET = UNetConfig(
    sample_size=16,
    in_channels=4,
    out_channels=4,
    block_channels=(32, 64, 64),
    attn_levels=(True, True, False),
    layers_per_block=1,
    num_heads=2,
    context_dim=32,
    context_len=16,
    groups=8,
    ff_mult=2,
)


def unet_attn_specs(cfg: UNetConfig):
    """Every attention call site in forward-call order, as
    ``(place, is_cross, resolution, heads, key_len, channels)`` tuples.

    Order contract (must match ``unet.apply_unet``'s call order): down blocks
    (per transformer block: self then cross), mid, up blocks."""
    specs = []

    def site(place, level):
        res = cfg.resolution_at(level)
        ch = cfg.block_channels[level]
        heads = cfg.heads_for(ch)
        for _ in range(cfg.transformer_depth):
            specs.append((place, False, res, heads, res * res, ch))       # self
            specs.append((place, True, res, heads, cfg.context_len, ch))  # cross

    for level in range(cfg.levels):                      # down
        if cfg.attn_levels[level]:
            for _ in range(cfg.layers_per_block):
                site("down", level)
    site("mid", cfg.levels - 1)                          # mid
    for level in reversed(range(cfg.levels)):            # up
        if cfg.attn_levels[level]:
            for _ in range(cfg.layers_per_block + 1):
                site("up", level)
    return specs


def unet_layout(cfg: UNetConfig, store_cfg: Optional[StoreConfig] = None
                ) -> AttnLayout:
    if store_cfg is None:
        # Store every map of at most a quarter of the latent side squared:
        # SD's 32²/16²/8² maps, and the two lower pyramid levels of TINY.
        store_cfg = StoreConfig(max_pixels=(cfg.sample_size // 2) ** 2)
    return build_layout(unet_attn_specs(cfg), store_cfg)


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """CLIP-style causal text transformer (SD-1.4: ViT-L/14 text tower)."""

    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    ff_mult: int = 4
    activation: str = "quick_gelu"         # CLIP-L uses quick_gelu
    causal: bool = True
    # Attention projection width (heads·head_dim). CLIP is square (None →
    # hidden_dim); LDMBert projects 1280 → 8·64 = 512 and back.
    attn_inner_dim: Optional[int] = None
    # LDMBert's q/k/v projections carry no bias (out_proj does).
    attn_qkv_bias: bool = True
    # Checkpoint-name architecture: 'clip' (CLIPTextModel) | 'ldmbert'.
    arch: str = "clip"

    @property
    def inner_dim(self) -> int:
        return self.attn_inner_dim or self.hidden_dim


SD14_TEXT = TextEncoderConfig()
TINY_TEXT = TextEncoderConfig(vocab_size=49408, hidden_dim=32, num_layers=2,
                              num_heads=2, max_length=16)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Latent autoencoder: KL (`AutoencoderKL`, SD) or VQ (`VQModel`, LDM).

    ``kind='vq'`` adds a codebook: decode first snaps each latent vector to
    its nearest codebook entry."""

    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215
    kind: str = "kl"                       # 'kl' | 'vq'
    num_codebook: int = 16384              # VQ only: codebook entries


SD14_VAE = VAEConfig()
TINY_VAE = VAEConfig(base_channels=16, channel_mults=(1, 2, 2), layers_per_block=1,
                     groups=8)  # 2 downsamples: 64² image ⇄ 16² latent


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduler constants, scoped per backend."""

    kind: str = "ddim"              # default sampler: 'ddim' | 'plms' | 'dpm'
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    clip_sample: bool = False
    plms_steps_offset: int = 1
    ddim_steps_offset: int = 0
    # 'epsilon' (SD-1.x / SD-2.1-base) or 'v_prediction' (SD-2.1 768-v).
    prediction_type: str = "epsilon"

    def steps_offset(self, kind: str) -> int:
        return self.plms_steps_offset if kind == "plms" else self.ddim_steps_offset


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """A full backend: text encoder + U-Net + VAE + scheduler defaults."""

    name: str
    unet: UNetConfig
    text: TextEncoderConfig
    vae: VAEConfig
    image_size: int = 512
    guidance_scale: float = 7.5
    num_steps: int = 50
    scheduler: SchedulerConfig = SchedulerConfig()

    @property
    def latent_size(self) -> int:
        return self.unet.sample_size


SD14 = PipelineConfig("sd-v1.4", SD14_UNET, SD14_TEXT, SD14_VAE, image_size=512)
TINY = PipelineConfig("tiny", TINY_UNET, TINY_TEXT, TINY_VAE, image_size=64,
                      num_steps=4)

# LDM text2im-large-256: BERT-style (non-causal, gelu) 1280-d text encoder
# (vocab 30522), 32² latent pyramid (256² image, f8 VQ autoencoder), heads
# at fixed head_dim 64 (5/10/20 per level), VQ codebook decode.
LDM_UNET = UNetConfig(
    sample_size=32,
    in_channels=4,
    out_channels=4,
    block_channels=(320, 640, 1280, 1280),
    attn_levels=(True, True, True, False),
    layers_per_block=2,
    head_dim=64,
    context_dim=1280,
    context_len=77,
)
LDM_TEXT = TextEncoderConfig(vocab_size=30522, hidden_dim=1280, num_layers=32,
                             num_heads=8, max_length=77, activation="gelu",
                             causal=False, attn_inner_dim=8 * 64,
                             attn_qkv_bias=False, arch="ldmbert")
# channel_mults (1,2,2,4) = 3 downsamples = f8: 256² image ⇄ 32² latent; the
# decode scales by 1 / 0.18215 as the KL kind's does.
LDM_VAE = VAEConfig(base_channels=128, channel_mults=(1, 2, 2, 4),
                    latent_channels=4, kind="vq", num_codebook=16384)
LDM256 = PipelineConfig("ldm-text2im-256", LDM_UNET, LDM_TEXT, LDM_VAE,
                        image_size=256, guidance_scale=5.0, num_steps=50,
                        scheduler=SchedulerConfig(
                            beta_start=0.0015, beta_end=0.0195,
                            plms_steps_offset=0))

# SD-2.1 family: OpenCLIP ViT-H text tower realized as 23 transformer layers
# (diffusers' checkpoint conversion truncates layer 24 so the final-LN
# output is the penultimate hidden state SD-2 conditions on), gelu
# activation, 1024-wide context; U-Net at fixed head_dim 64 (5, 10 and 20
# heads per level). The 768-v variant predicts v, not ε.
SD21_TEXT = TextEncoderConfig(hidden_dim=1024, num_layers=23, num_heads=16,
                              activation="gelu")
SD21_UNET = UNetConfig(context_dim=1024, head_dim=64)
SD21_BASE = PipelineConfig("sd-v2.1-base", SD21_UNET, SD21_TEXT, SD14_VAE,
                           image_size=512)
SD21 = PipelineConfig(
    "sd-v2.1", dataclasses.replace(SD21_UNET, sample_size=96), SD21_TEXT,
    SD14_VAE, image_size=768,
    scheduler=SchedulerConfig(prediction_type="v_prediction"))

# Tiny LDM-shaped backend for tests: per-level heads via head_dim, the
# non-causal text encoder without q/k/v bias, the VQ decoder and the LDM β
# schedule, at toy sizes.
TINY_LDM_UNET = dataclasses.replace(
    TINY_UNET, num_heads=1, head_dim=16, block_channels=(32, 64, 64))
TINY_LDM_TEXT = dataclasses.replace(
    TINY_TEXT, causal=False, activation="gelu", attn_inner_dim=32,
    attn_qkv_bias=False, arch="ldmbert", vocab_size=30522)
TINY_LDM_VAE = dataclasses.replace(TINY_VAE, kind="vq", num_codebook=64)
TINY_LDM = PipelineConfig("tiny-ldm", TINY_LDM_UNET, TINY_LDM_TEXT,
                          TINY_LDM_VAE, image_size=64, num_steps=4,
                          guidance_scale=5.0,
                          scheduler=SchedulerConfig(
                              beta_start=0.0015, beta_end=0.0195,
                              plms_steps_offset=0))

# The presets the port runs (CLI ``--preset``): the JAX package's table.
PRESET_CONFIGS = {
    "tiny": TINY,
    "sd14": SD14,
    "sd21": SD21,
    "sd21base": SD21_BASE,
    "ldm256": LDM256,
    "tiny_ldm": TINY_LDM,
}
