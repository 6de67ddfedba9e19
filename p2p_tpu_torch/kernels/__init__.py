"""The port's hand-written CUDA kernels and their dispatch.

- K1 :func:`flash.flash_attention` — flash attention forward
  (``csrc/flash_attn.cu``).
- K2 :func:`fused_edit.edit_attention` — softmax with the prompt-to-prompt
  edit inside it (``csrc/fused_edit.cu``).

Each wrapper runs its plain PyTorch version on CPU tensors, launches its
kernel on CUDA tensors (built on first use by :mod:`.build`) and counts its
launches in ``<wrapper>.launches``.
"""

from .dispatch import (
    VARIANT_FLASH,
    VARIANT_FUSED,
    VARIANT_MATERIALIZED,
    VARIANT_USE,
    KernelConfig,
    site_name,
    site_variant,
)
from .flash import flash_attention, flash_attention_plain
from .fused_edit import edit_attention, edit_attention_plain, fused_site_attention


def launch_counts() -> dict:
    """``{kernel: launches}`` of every kernel wrapper."""
    return {"flash_attn": flash_attention.launches,
            "fused_edit": edit_attention.launches}


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    edit_attention.launches = 0


__all__ = [
    "VARIANT_FLASH", "VARIANT_FUSED", "VARIANT_MATERIALIZED", "VARIANT_USE",
    "KernelConfig", "site_name", "site_variant", "flash_attention",
    "flash_attention_plain", "edit_attention", "edit_attention_plain",
    "fused_site_attention", "launch_counts", "reset_launch_counts",
]
