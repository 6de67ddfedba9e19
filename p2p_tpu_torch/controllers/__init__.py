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
from .edit import EditParams, edit_cross_attention, edit_self_attention
from .factory import (
    attention_refine,
    attention_replace,
    empty_control,
    make_controller,
)

__all__ = [
    "AttnLayout", "AttnMeta", "Controller", "StoreConfig",
    "apply_attention_control", "apply_step_callback", "build_layout",
    "controller_touches", "init_store_state", "EditParams",
    "edit_cross_attention", "edit_self_attention", "attention_refine",
    "attention_replace", "empty_control", "make_controller",
]
