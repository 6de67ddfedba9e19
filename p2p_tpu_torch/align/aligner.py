"""Host-side prompt-alignment precompute (runs once per edit, in numpy).

Builds the token-mapping tensors that parameterize the cross-attention edits:

- **Replacement mapper** — a dense ``(L, L)`` matrix per edit prompt that
  projects the source prompt's attention columns onto the edit prompt's token
  grid (behavioral spec: reference `seq_aligner.py:152-195`; consumed by
  the einsum at reference `main.py:218`).
- **Refinement mapper** — an integer gather (edit-token → source-token index)
  plus a 0/1 ``alphas`` vector marking which edit tokens existed in the
  source, produced by Needleman–Wunsch global alignment over token ids
  (spec: reference `seq_aligner.py:61-128`).

These run on host exactly once per controller construction — O(77²) — so
there is nothing to accelerate; the TPU-side hot path consumes the resulting
fixed-shape arrays.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..utils.tokenizer import Tokenizer
from .words import get_word_inds

GAP, MATCH, MISMATCH = 0, 1, -1  # reference `seq_aligner.py:110`


def needleman_wunsch(x: Sequence[int], y: Sequence[int],
                     gap: int = GAP, match: int = MATCH, mismatch: int = MISMATCH
                     ) -> List[Tuple[int, int]]:
    """Global alignment of two id sequences; returns ``(y_pos, x_pos)`` pairs
    for every position of ``y``, with ``x_pos = -1`` where ``y`` inserted a
    token absent from ``x``.

    Tie-breaking matches the reference exactly (left-gap preferred over
    up-gap over diagonal when scores tie — reference `seq_aligner.py:70-75`),
    which matters for reproducing its mappers bit-for-bit. Implemented as a
    vectorized-row DP (numpy) rather than the reference's per-cell Python loop.
    """
    nx, ny = len(x), len(y)
    xa = np.asarray(x)
    ya = np.asarray(y)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    score[0, 1:] = np.arange(1, ny + 1) * gap
    score[1:, 0] = np.arange(1, nx + 1) * gap
    # traceback codes: 1=left (gap in x), 2=up (gap in y), 3=diag, 4=origin
    trace = np.zeros((nx + 1, ny + 1), dtype=np.int8)
    trace[0, 1:] = 1
    trace[1:, 0] = 2
    trace[0, 0] = 4

    sub = np.where(xa[:, None] == ya[None, :], match, mismatch)  # (nx, ny)
    for i in range(1, nx + 1):
        up = score[i - 1, 1:] + gap
        diag = score[i - 1, :-1] + sub[i - 1]
        # The row has a left-to-right dependency; keep that one scalar loop.
        row = score[i]
        trow = trace[i]
        for j in range(1, ny + 1):
            left = row[j - 1] + gap
            best = max(left, up[j - 1], diag[j - 1])
            row[j] = best
            trow[j] = 1 if best == left else (2 if best == up[j - 1] else 3)

    pairs: List[Tuple[int, int]] = []
    i, j = nx, ny
    while i > 0 or j > 0:
        code = trace[i, j]
        if code == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif code == 1:
            j -= 1
            pairs.append((j, -1))
        elif code == 2:
            i -= 1
        else:  # origin
            break
    pairs.reverse()
    return pairs


def refinement_mapper_single(src: str, tgt: str, tokenizer: Tokenizer,
                             max_len: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """Integer gather + alphas for one (source, edit) prompt pair.

    Output spec matches reference `seq_aligner.py:107-118`: positions
    past the aligned length continue as identity (``len(y), len(y)+1, ...``)
    and their alphas stay 1.
    """
    x_ids = tokenizer.encode(src)
    y_ids = tokenizer.encode(tgt)
    pairs = needleman_wunsch(x_ids, y_ids)
    n = len(pairs)
    mapper = np.zeros(max_len, dtype=np.int32)
    alphas = np.ones(max_len, dtype=np.float32)
    pa = np.asarray(pairs, dtype=np.int32)  # (n, 2) = (y_pos, x_pos)
    mapper[:n] = pa[:, 1]
    alphas[:n] = (pa[:, 1] != -1).astype(np.float32)
    mapper[n:] = len(y_ids) + np.arange(max_len - len(y_ids), dtype=np.int32)
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer: Tokenizer,
                          max_len: int = 77) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked refinement mappers for prompts[1:] against prompts[0].

    Returns ``mapper (E, L) int32`` and ``alphas (E, L) float32``
    (reference `seq_aligner.py:121-128`).
    """
    out = [refinement_mapper_single(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    mappers = np.stack([m for m, _ in out])
    alphas = np.stack([a for _, a in out])
    return mappers, alphas


def replacement_mapper_single(src: str, tgt: str, tokenizer: Tokenizer,
                              max_len: int = 77) -> np.ndarray:
    """Dense ``(L, L)`` projection matrix for a word-swap edit.

    Word-level diff of two prompts with equal word counts; swapped words'
    token spans cross-connect (weight ``1/len(target_span)`` when span sizes
    differ), everything else is identity
    (reference `seq_aligner.py:152-185`). Rows index source tokens,
    columns index edit-prompt tokens; when every swapped word keeps its
    token count, each source-token ROW carries unit mass and ``attn @ m``
    preserves total attention mass. When a swapped word's token count
    CHANGES, the reference's trailing diagonal (noted below) misaligns the
    tail: shrinking spans double-count rows (mass > 1), growing spans skip
    rows (mass 0) — both reproduced bit-for-bit for pixel parity.
    """
    words_x = src.split(" ")
    words_y = tgt.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit requires prompts with the same word count, "
            f"got {len(words_x)} vs {len(words_y)} — use AttentionRefine for "
            "prompts of different lengths."
        )
    diff = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    spans_src = [get_word_inds(src, i, tokenizer) for i in diff]
    spans_tgt = [get_word_inds(tgt, i, tokenizer) for i in diff]

    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = 0
    k = 0
    while i < max_len and j < max_len:
        if k < len(spans_src) and len(spans_src[k]) > 0 and spans_src[k][0] == i:
            s, t = spans_src[k], spans_tgt[k]
            if len(s) == len(t):
                mapper[s, t] = 1.0
            else:
                mapper[np.ix_(s, t)] = 1.0 / len(t)
            k += 1
            i += len(s)
            j += len(t)
        elif k < len(spans_src):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            # Past the last replaced span the reference switches to a pure
            # diagonal keyed by the *target* index (`seq_aligner.py:179-182`:
            # ``mapper[j, j] = 1``). NOTE: when a replaced source span is
            # longer than its target span this diagonal overlaps rows the
            # span block already used (row sums then exceed 1 and trailing
            # same-word tokens misalign by the length difference) — a quirk
            # of the reference we reproduce bit-for-bit for pixel parity;
            # it is pinned in tests/test_align_properties.py.
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer: Tokenizer,
                           max_len: int = 77) -> np.ndarray:
    """Stacked ``(E, L, L)`` replacement mappers for prompts[1:] vs prompts[0]
    (reference `seq_aligner.py:189-195`)."""
    return np.stack(
        [replacement_mapper_single(prompts[0], p, tokenizer, max_len) for p in prompts[1:]]
    )
