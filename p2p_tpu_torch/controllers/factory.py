"""Controller constructors — the user-facing edit API.

The PyTorch counterpart of ``p2p_tpu/controllers/factory.py``: Replace,
Refine and Reweight edits, LocalBlend masks, and ``make_controller``, the
one-call assembly of the null-text notebook. Parameters are precomputed
host-side (numpy) and held as CPU tensors; the sampler moves them to its
device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..align.aligner import get_refinement_mapper, get_replacement_mapper
from ..align.words import (
    Bounds,
    get_equalizer,
    get_time_words_attention_alpha,
    get_word_inds,
)
from ..utils.tokenizer import Tokenizer
from .base import Controller
from .blend import BlendParams
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


def local_blend(
    prompts: Sequence[str],
    words: Sequence[Union[str, Sequence[str]]],
    tokenizer: Tokenizer,
    substruct_words: Optional[Sequence[Union[str, Sequence[str]]]] = None,
    start_blend: float = 0.0,
    num_steps: int = 50,
    th: Tuple[float, float] = (0.3, 0.3),
    resolution: int = 16,
    max_len: Optional[int] = None,
) -> BlendParams:
    """LocalBlend word masks: per prompt, a one-hot over the token positions
    of its words. ``start_blend`` is a fraction of ``num_steps``."""
    L = max_len or tokenizer.model_max_length

    def one_hot(word_lists) -> torch.Tensor:
        alpha = np.zeros((len(prompts), L), dtype=np.float32)
        for i, (prompt, ws) in enumerate(zip(prompts, word_lists)):
            if isinstance(ws, str):
                ws = [ws]
            for w in ws:
                alpha[i, get_word_inds(prompt, w, tokenizer)] = 1.0
        return torch.from_numpy(alpha)

    return BlendParams(
        alpha_layers=one_hot(words),
        substruct_layers=(one_hot(substruct_words)
                          if substruct_words is not None else None),
        start_blend=int(start_blend * num_steps),
        th_pool=float(th[0]),
        th_nopool=float(th[1]),
        resolution=resolution,
    )


def attention_replace(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    tokenizer: Tokenizer,
    local_blend: Optional[BlendParams] = None,
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
    return Controller(edit=edit, blend=local_blend, store=store)


def attention_refine(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    tokenizer: Tokenizer,
    local_blend: Optional[BlendParams] = None,
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
    return Controller(edit=edit, blend=local_blend, store=store)


def attention_reweight(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: CrossSteps,
    self_replace_steps: Union[float, Tuple[float, float]],
    equalizer,
    tokenizer: Tokenizer,
    local_blend: Optional[BlendParams] = None,
    base: Optional[Controller] = None,
    self_max_pixels: int = 16 * 16,
    max_len: Optional[int] = None,
    store: bool = True,
) -> Controller:
    """Per-token attention rescaling by ``equalizer`` ``(E, L)``, stacked on
    ``base`` (the reference's ``prev_controller``): ``base``'s cross
    transform runs first, and a base Reweight's equalizer multiplies in."""
    L = max_len or tokenizer.model_max_length
    lo, hi = _self_window(num_steps, self_replace_steps)
    eq = torch.as_tensor(np.asarray(equalizer), dtype=torch.float32)
    if base is not None and base.edit is not None:
        kind = base.edit.kind
        mapper = base.edit.mapper
        refine_alphas = base.edit.refine_alphas
        if base.edit.equalizer is not None:
            eq = eq * base.edit.equalizer
    else:
        kind, mapper, refine_alphas = "none", None, None
    if base is not None and local_blend is None:
        local_blend = base.blend
    edit = EditParams(
        cross_alpha=_cross_alpha(prompts, num_steps, cross_replace_steps, tokenizer, L),
        mapper=mapper,
        refine_alphas=refine_alphas,
        equalizer=eq,
        kind=kind,
        self_start=lo,
        self_end=hi,
        self_max_pixels=self_max_pixels,
    )
    return Controller(edit=edit, blend=local_blend, store=store)


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
    blend_resolution: int = 16,
) -> Controller:
    """One-call controller assembly (defaults of the null-text variant:
    ``self_max_pixels=32²``, LocalBlend starting after 0.2 of the steps).
    ``equalizer_params`` = ``{"words": ..., "values": ...}`` adds a Reweight
    stage on top."""
    lb = None
    if blend_words is not None:
        lb = local_blend(prompts, blend_words, tokenizer, start_blend=0.2,
                         num_steps=num_steps, resolution=blend_resolution)
    maker = attention_replace if is_replace_controller else attention_refine
    controller = maker(prompts, num_steps, cross_replace_steps, self_replace_steps,
                       tokenizer, local_blend=lb, self_max_pixels=self_max_pixels)
    if equalizer_params is not None:
        eq = get_equalizer(prompts[1], equalizer_params["words"],
                           equalizer_params["values"], tokenizer, mode="paired")
        controller = attention_reweight(
            prompts, num_steps, cross_replace_steps, self_replace_steps, eq,
            tokenizer, local_blend=lb, base=controller,
            self_max_pixels=self_max_pixels)
    return controller
