"""The port's hand-written CUDA kernels and their dispatch.

- K1 :func:`flash.flash_attention` — flash attention forward
  (``csrc/flash_attn.cu``).
- K3 :func:`flash.flash_attention_residuals` — the same kernel, also
  writing each row's softmax max and sum.
- K4 :func:`flash_bwd.flash_attention_bwd` — flash attention backward, a
  dk/dv pass (:func:`flash_bwd.flash_attention_bwd_dkv`) and a dq pass
  (:func:`flash_bwd.flash_attention_bwd_dq`), ``csrc/flash_attn_bwd.cu``;
  with K3 it makes :class:`flash_bwd.FlashAttentionFunction`.
- K2 :func:`fused_edit.edit_attention` — softmax with the prompt-to-prompt
  edit inside it (``csrc/fused_edit.cu``).

Each wrapper runs its plain PyTorch version on CPU tensors, launches its
kernel on CUDA tensors (built on first use by :mod:`.build`) and counts its
launches in ``<wrapper>.launches``; K1's and K3's wrappers also count the
merge kernel their d = 512 calls launch when they split the keys, in
``<wrapper>.merge_launches`` (:func:`merge_launches`).
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
from .flash import (
    flash_attention,
    flash_attention_plain,
    flash_attention_residuals,
    flash_attention_residuals_plain,
)
from .flash_bwd import (
    FlashAttentionFunction,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
)
from .fused_edit import edit_attention, edit_attention_plain, fused_site_attention


def launch_counts() -> dict:
    """``{kernel: launches}`` of every kernel wrapper."""
    return {"flash_attn": flash_attention.launches,
            "fused_edit": edit_attention.launches,
            "flash_attn_residuals": flash_attention_residuals.launches,
            "flash_attn_bwd_dq": flash_attention_bwd_dq.launches,
            "flash_attn_bwd_dkv": flash_attention_bwd_dkv.launches}


def merge_launches() -> int:
    """Launches of K1's key-split merge kernel, by K1's and K3's wrappers."""
    return flash_attention.merge_launches + flash_attention_residuals.merge_launches


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.merge_launches = 0
    edit_attention.launches = 0
    flash_attention_residuals.launches = 0
    flash_attention_residuals.merge_launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dkv.launches = 0


__all__ = [
    "VARIANT_FLASH", "VARIANT_FUSED", "VARIANT_MATERIALIZED", "VARIANT_USE",
    "KernelConfig", "site_name", "site_variant", "flash_attention",
    "flash_attention_plain", "flash_attention_residuals",
    "flash_attention_residuals_plain", "flash_attention_bwd",
    "flash_attention_bwd_plain", "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain", "FlashAttentionFunction",
    "edit_attention", "edit_attention_plain",
    "fused_site_attention", "launch_counts", "merge_launches",
    "reset_launch_counts",
]
