"""Controller constructors — the user-facing edit API.

The PyTorch counterpart of ``p2p_tpu/controllers/factory.py`` for the
Replace and Refine edits. Parameters are precomputed host-side (numpy) and
held as CPU tensors; the sampler moves them to its device. LocalBlend
(``blend_words``) and Reweight (``equalizer_params``) are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..align.aligner import get_refinement_mapper, get_replacement_mapper
from ..align.words import Bounds, get_time_words_attention_alpha
from ..utils.tokenizer import Tokenizer
from .base import Controller
from .edit import EditParams

CrossSteps = Union[Bounds, Dict[str, Bounds]]


def _self_window(num_steps: int, self_replace_steps: Union[float, Tuple[float, float]]
                 ) -> Tuple[int, int]:
    """Float → (0, v) window, scaled to step counts."""
    if isinstance(self_replace_steps, (int, float)):
        self_replace_steps = (0.0, float(self_replace_steps))
    return int(num_steps * self_replace_steps[0]), int(num_steps * self_replace_steps[1])


def _cross_alpha(prompts, num_steps, cross_replace_steps, tokenizer, max_len):
    return torch.from_numpy(
        get_time_words_attention_alpha(prompts, num_steps, cross_replace_steps,
                                       tokenizer, max_num_words=max_len))


def empty_control() -> Controller:
    """The identity controller."""
    return Controller()


def attention_replace(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    tokenizer: Tokenizer,
    self_max_pixels: int = 16 * 16,
    max_len: Optional[int] = None,
    store: bool = True,
) -> Controller:
    """Word-swap edit. ``store=True`` accumulates the ≤32²-pixel maps as the
    reference's edit controllers do; pass False to skip the store."""
    L = max_len or tokenizer.model_max_length
    lo, hi = _self_window(num_steps, self_replace_steps)
    edit = EditParams(
        cross_alpha=_cross_alpha(prompts, num_steps, cross_replace_steps, tokenizer, L),
        mapper=torch.from_numpy(get_replacement_mapper(prompts, tokenizer, max_len=L)),
        kind="replace",
        self_start=lo,
        self_end=hi,
        self_max_pixels=self_max_pixels,
    )
    return Controller(edit=edit, store=store)


def attention_refine(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    tokenizer: Tokenizer,
    self_max_pixels: int = 16 * 16,
    max_len: Optional[int] = None,
    store: bool = True,
) -> Controller:
    """Token-add edit via Needleman–Wunsch alignment."""
    L = max_len or tokenizer.model_max_length
    mapper, alphas = get_refinement_mapper(prompts, tokenizer, max_len=L)
    lo, hi = _self_window(num_steps, self_replace_steps)
    edit = EditParams(
        cross_alpha=_cross_alpha(prompts, num_steps, cross_replace_steps, tokenizer, L),
        mapper=torch.from_numpy(mapper).long(),
        refine_alphas=torch.from_numpy(alphas)[:, None, None, :],
        kind="refine",
        self_start=lo,
        self_end=hi,
        self_max_pixels=self_max_pixels,
    )
    return Controller(edit=edit, store=store)


def make_controller(
    prompts: Sequence[str],
    is_replace_controller: bool,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    tokenizer: Tokenizer,
    num_steps: int = 50,
    blend_words=None,
    equalizer_params: Optional[dict] = None,
    self_max_pixels: int = 32 * 32,
) -> Controller:
    """One-call controller assembly (defaults of the null-text variant:
    ``self_max_pixels=32²``)."""
    if blend_words is not None:
        raise NotImplementedError("LocalBlend (blend_words) is not ported to "
                                  "p2p_tpu_torch yet")
    if equalizer_params is not None:
        raise NotImplementedError("Reweight (equalizer_params) is not ported to "
                                  "p2p_tpu_torch yet")
    maker = attention_replace if is_replace_controller else attention_refine
    return maker(prompts, num_steps, cross_replace_steps, self_replace_steps,
                 tokenizer, self_max_pixels=self_max_pixels)
