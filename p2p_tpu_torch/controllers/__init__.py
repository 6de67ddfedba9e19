from .base import (
    AttnLayout,
    AttnMeta,
    Controller,
    StoreConfig,
    apply_attention_control,
    apply_step_callback,
    build_layout,
    controller_touches,
    init_store_state,
)
from .blend import BlendParams, apply_local_blend
from .edit import EditParams, edit_cross_attention, edit_self_attention
from .factory import (
    attention_refine,
    attention_replace,
    attention_reweight,
    empty_control,
    local_blend,
    make_controller,
)

__all__ = [
    "AttnLayout", "AttnMeta", "Controller", "StoreConfig",
    "apply_attention_control", "apply_step_callback", "build_layout",
    "controller_touches", "init_store_state", "BlendParams",
    "apply_local_blend", "EditParams",
    "edit_cross_attention", "edit_self_attention", "attention_refine",
    "attention_replace", "attention_reweight", "empty_control",
    "local_blend", "make_controller",
]
