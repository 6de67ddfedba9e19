"""The port's hand-written CUDA kernels and their dispatch.

- K1 :func:`flash.flash_attention` — flash attention forward
  (``csrc/flash_attn.cu`` in f32 at d = 40 and 512,
  ``csrc/flash_fwd_tf32_sm90.cu`` in f32 at d = 64, ``csrc/flash_fwd_sm90.cu``
  in bf16).
- K3 :func:`flash.flash_attention_residuals` — the same kernel, also
  writing each row's softmax max and sum.
- K4 :func:`flash_bwd.flash_attention_bwd` — flash attention backward, a
  dk/dv pass (:func:`flash_bwd.flash_attention_bwd_dkv`) and a dq pass
  (:func:`flash_bwd.flash_attention_bwd_dq`), ``csrc/flash_attn_bwd.cu``
  (f32 at d = 40), ``csrc/flash_bwd_tf32_sm90.cu`` (f32 at d = 64) and
  ``csrc/flash_bwd_sm90.cu`` (bf16); with K3 it makes
  :class:`flash_bwd.FlashAttentionFunction`.
- K2 :func:`fused_edit.edit_attention` — softmax with the prompt-to-prompt
  edit inside it (``csrc/fused_edit.cu``): a fold kernel, then the main
  kernel.
- :func:`reduce.window_sum` — the bf16 sums of the norms' backward in
  the JAX program's order and roundings (``csrc/window_sum.cu``), one
  launch a stage.

Each wrapper runs its plain PyTorch version on CPU tensors, launches its
kernel on CUDA tensors (built on first use by :mod:`.build`) and counts its
launches in ``<wrapper>.launches`` (K1's, K3's and K4's passes' by dtype
and head dim, in ``<wrapper>.by_head_dim``, :func:`head_dim_launch_counts`); K1's and
K3's wrappers also count the merge kernel their d = 512 calls launch when
they split the keys, in ``<wrapper>.merge_launches``
(:func:`merge_launches`), and the split pass their f32 d = 64 calls launch
before the forward, in ``<wrapper>.split_launches``
(:func:`split_launches`), and K2's wrapper the fold kernel it launches
before the main kernel, in ``edit_attention.fold_launches``
(:func:`fold_launches`). Every kernel also takes bf16 operands (K1 and K3
at d = 40, 64 and 512, K4 at d = 40 and 64); those launches count apart
(:func:`bf16_launch_counts`), and K1's and K3's bf16 merges in
:func:`merge_launches` with the f32 ones.
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
from .reduce import window_sum, window_sum_plain


def _launches(wrapper, dtype: str) -> int:
    """K1's or K3's launches in ``dtype`` (``"f32"`` or ``"bf16"``), summed
    over the head dims."""
    return sum(n for key, n in wrapper.by_head_dim.items() if key.split()[0] == dtype)


def launch_counts() -> dict:
    """``{kernel: launches}`` of every kernel wrapper."""
    return {"flash_attn": _launches(flash_attention, "f32"),
            "fused_edit": edit_attention.launches,
            "flash_attn_residuals": _launches(flash_attention_residuals, "f32"),
            "flash_attn_bwd_dq": flash_attention_bwd_dq.launches,
            "flash_attn_bwd_dkv": flash_attention_bwd_dkv.launches}


def merge_launches() -> int:
    """Launches of K1's key-split merge kernel, by K1's and K3's wrappers."""
    return flash_attention.merge_launches + flash_attention_residuals.merge_launches


def split_launches() -> int:
    """Launches of the f32 d = 64 forward's split pass (one per K1 or K3
    call in f32 at d = 64), by K1's and K3's wrappers."""
    return flash_attention.split_launches + flash_attention_residuals.split_launches


def fold_launches() -> int:
    """Launches of K2's fold kernel, one per K2 launch."""
    return edit_attention.fold_launches


def bf16_launch_counts() -> dict:
    """``{kernel: launches}`` of the bf16 kernels: K1 (d = 40, 64 and 512), K2
    and its fold, K3, K4's two passes and the norms' backward sums."""
    return {"flash_attn_bf16": _launches(flash_attention, "bf16"),
            "fused_edit_bf16": edit_attention.bf16_launches,
            "fused_edit_fold_bf16": edit_attention.bf16_fold_launches,
            "flash_attn_residuals_bf16": _launches(flash_attention_residuals, "bf16"),
            "flash_attn_bwd_dq_bf16": flash_attention_bwd_dq.bf16_launches,
            "flash_attn_bwd_dkv_bf16": flash_attention_bwd_dkv.bf16_launches,
            "window_sum_bf16": window_sum.launches}


def head_dim_launch_counts() -> dict:
    """``{"K1 bf16 d=64": launches, "K4 dkv f32 d=64": ...}``: K1's, K3's
    and K4's two passes' launches by dtype and head dim, each of which runs
    a kernel of its own."""
    return {f"{name} {key}": n
            for name, fn in (("K1", flash_attention), ("K3", flash_attention_residuals),
                             ("K4 dkv", flash_attention_bwd_dkv),
                             ("K4 dq", flash_attention_bwd_dq))
            for key, n in sorted(fn.by_head_dim.items())}


def reset_launch_counts() -> None:
    flash_attention.merge_launches = 0
    edit_attention.launches = 0
    edit_attention.fold_launches = 0
    edit_attention.bf16_launches = 0
    edit_attention.bf16_fold_launches = 0
    flash_attention_residuals.merge_launches = 0
    flash_attention.split_launches = 0
    flash_attention_residuals.split_launches = 0
    flash_attention.by_head_dim.clear()
    flash_attention_residuals.by_head_dim.clear()
    flash_attention_bwd_dkv.by_head_dim.clear()
    flash_attention_bwd_dq.by_head_dim.clear()
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dq.bf16_launches = 0
    flash_attention_bwd_dkv.launches = 0
    flash_attention_bwd_dkv.bf16_launches = 0
    window_sum.launches = 0


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
    "head_dim_launch_counts",
    "launch_counts", "merge_launches", "split_launches",
    "reset_launch_counts", "window_sum", "window_sum_plain",
]
