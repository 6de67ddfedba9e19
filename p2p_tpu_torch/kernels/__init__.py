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
  edit inside it (``csrc/fused_edit.cu``): a fold kernel, then the main
  kernel.

Each wrapper runs its plain PyTorch version on CPU tensors, launches its
kernel on CUDA tensors (built on first use by :mod:`.build`) and counts its
launches in ``<wrapper>.launches``; K1's and K3's wrappers also count the
merge kernel their d = 512 calls launch when they split the keys, in
``<wrapper>.merge_launches`` (:func:`merge_launches`), and K2's wrapper the
fold kernel it launches before the main kernel, in
``edit_attention.fold_launches`` (:func:`fold_launches`). Every kernel also
takes bf16 operands (K1 and K3 at d = 40 and 512, K4 at d = 40); those
launches count apart (:func:`bf16_launch_counts`), and K1's and K3's bf16
merges in :func:`merge_launches` with the f32 ones.
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


def fold_launches() -> int:
    """Launches of K2's fold kernel, one per K2 launch."""
    return edit_attention.fold_launches


def bf16_launch_counts() -> dict:
    """``{kernel: launches}`` of the bf16 kernels: K1 (d = 40 and 512), K2
    and its fold, K3 and K4's two passes."""
    return {"flash_attn_bf16": flash_attention.bf16_launches,
            "fused_edit_bf16": edit_attention.bf16_launches,
            "fused_edit_fold_bf16": edit_attention.bf16_fold_launches,
            "flash_attn_residuals_bf16": flash_attention_residuals.bf16_launches,
            "flash_attn_bwd_dq_bf16": flash_attention_bwd_dq.bf16_launches,
            "flash_attn_bwd_dkv_bf16": flash_attention_bwd_dkv.bf16_launches}


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.bf16_launches = 0
    flash_attention.merge_launches = 0
    edit_attention.launches = 0
    edit_attention.fold_launches = 0
    edit_attention.bf16_launches = 0
    edit_attention.bf16_fold_launches = 0
    flash_attention_residuals.launches = 0
    flash_attention_residuals.bf16_launches = 0
    flash_attention_residuals.merge_launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dq.bf16_launches = 0
    flash_attention_bwd_dkv.launches = 0
    flash_attention_bwd_dkv.bf16_launches = 0


__all__ = [
    "VARIANT_FLASH", "VARIANT_FUSED", "VARIANT_MATERIALIZED", "VARIANT_USE",
    "KernelConfig", "site_name", "site_variant", "flash_attention",
    "flash_attention_plain", "flash_attention_residuals",
    "flash_attention_residuals_plain", "flash_attention_bwd",
    "flash_attention_bwd_plain", "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_plain", "FlashAttentionFunction",
    "edit_attention", "edit_attention_plain",
    "fused_site_attention", "bf16_launch_counts", "fold_launches",
    "launch_counts", "merge_launches",
    "reset_launch_counts",
]
