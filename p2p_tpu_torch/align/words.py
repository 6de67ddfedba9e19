"""Word→token indexing and the per-step/per-token edit schedules.

Host-side precompute producing the fixed-shape arrays the jitted sampling loop
indexes by step:

- ``get_word_inds`` — token indices of a whitespace word inside a prompt
  (spec: reference `ptp_utils.py:245-263`).
- ``get_time_words_attention_alpha`` — the ``(T+1, E, 1, 1, L)`` 0/1 schedule
  that turns ``cross_replace_steps`` (a float or a per-word dict) into a
  per-step/per-token blend weight (reference `ptp_utils.py:266-297`).
- ``get_equalizer`` — per-token scale vectors for AttentionReweight, in both
  the sweep form (reference `main.py:281-290`, one row per value) and the
  paired form (reference `null_text.py:340-349`, one row, word↔value).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from ..utils.tokenizer import Tokenizer, token_strings

Bounds = Union[float, Tuple[float, float]]


def get_word_inds(text: str, word_place: Union[int, str, List[int]],
                  tokenizer: Tokenizer) -> np.ndarray:
    """Token indices (1-based, accounting for BOS) covering a word of ``text``.

    ``word_place`` is a whitespace-word position, a word string (all
    occurrences), or a list of positions. Sub-word tokens are attributed to
    words by accumulating decoded-token lengths until they cover the current
    word, exactly as reference `ptp_utils.py:245-263` does.
    """
    split_text = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(split_text) if word_place == w]
    elif isinstance(word_place, int):
        places = [word_place]
    else:
        places = list(word_place)
    out: List[int] = []
    if places:
        pieces = token_strings(tokenizer, text)
        cur_len, ptr = 0, 0
        for i, piece in enumerate(pieces):
            cur_len += len(piece)
            if ptr in places:
                out.append(i + 1)
            if ptr < len(split_text) and cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out, dtype=np.int64)


def update_alpha_time_word(alpha: np.ndarray, bounds: Bounds, prompt_ind: int,
                           word_inds: np.ndarray | None = None) -> np.ndarray:
    """Write a 0/1 step window into ``alpha[(step), prompt_ind, word_inds]``
    (reference `ptp_utils.py:266-276`). ``bounds`` as a float means
    ``(0, bounds)``; fractions index into the step axis."""
    if isinstance(bounds, (int, float)):
        bounds = (0.0, float(bounds))
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[Bounds, Dict[str, Bounds]],
    tokenizer: Tokenizer,
    max_num_words: int = 77,
) -> np.ndarray:
    """Build the ``(num_steps+1, E, 1, 1, L)`` cross-replace schedule
    (reference `ptp_utils.py:279-297`).

    A plain float/tuple applies to every token; a dict maps words (of the edit
    prompts) to their own step windows, with ``"default_"`` as the fallback.
    """
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps = {**cross_replace_steps, "default_": (0.0, 1.0)}
    n_edit = len(prompts) - 1
    alpha = np.zeros((num_steps + 1, n_edit, max_num_words), dtype=np.float32)
    for i in range(n_edit):
        update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, bounds in cross_replace_steps.items():
        if key == "default_":
            continue
        for i in range(1, len(prompts)):
            inds = get_word_inds(prompts[i], key, tokenizer)
            if len(inds) > 0:
                update_alpha_time_word(alpha, bounds, i - 1, inds)
    return alpha.reshape(num_steps + 1, n_edit, 1, 1, max_num_words)


def get_equalizer(
    text: str,
    word_select: Union[int, str, Sequence[Union[int, str]]],
    values: Sequence[float],
    tokenizer: Tokenizer,
    mode: str = "sweep",
) -> np.ndarray:
    """Per-token attention scale vectors for AttentionReweight.

    - ``mode='sweep'``: ``(len(values), L)`` — every selected word gets scale
      ``values[v]`` in row ``v`` (the equalizer-sweep form,
      reference `main.py:281-290`).
    - ``mode='paired'``: ``(1, L)`` — ``word_select[k]`` gets ``values[k]``
      (reference `null_text.py:340-349`).
    """
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    L = tokenizer.model_max_length
    if mode == "sweep":
        eq = np.ones((len(values), L), dtype=np.float32)
        vals = np.asarray(values, dtype=np.float32)
        for word in word_select:
            inds = get_word_inds(text, word, tokenizer)
            eq[:, inds] = vals[:, None]
    elif mode == "paired":
        eq = np.ones((1, L), dtype=np.float32)
        for word, val in zip(word_select, values):
            inds = get_word_inds(text, word, tokenizer)
            eq[:, inds] = float(val)
    else:
        raise ValueError(f"unknown equalizer mode: {mode!r}")
    return eq
