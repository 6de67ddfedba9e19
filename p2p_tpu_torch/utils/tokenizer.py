"""Tokenizer protocol and the vocab-free hash tokenizer.

A jax-free copy of ``p2p_tpu/utils/tokenizer.py`` (``Tokenizer``,
``pad_ids``, ``token_strings``, ``HashWordTokenizer``); the port must not
import the JAX package, and ``tests/test_torch_copies.py`` holds the copy
equal to its original. The CLIP BPE tokenizer is not ported yet.

The framework uses a tokenizer through three operations: ``encode(text)``
(with BOS/EOS), per-token ``decode([id])`` (word-index lookup) and
fixed-length padding.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    """The minimal tokenizer surface the framework depends on."""

    bos_token_id: int
    eos_token_id: int
    model_max_length: int

    def encode(self, text: str) -> List[int]:
        """Tokenize to ids, including BOS and EOS (unpadded)."""
        ...

    def decode(self, ids: Sequence[int]) -> str:
        """Inverse of encode for a list of ids (special tokens included)."""
        ...


def pad_ids(ids: Sequence[int], max_length: int, pad_id: int) -> List[int]:
    """Pad/truncate to ``max_length``; truncation keeps EOS as the final
    token (HF ``padding='max_length', truncation=True``)."""
    ids = list(ids)
    if len(ids) > max_length:
        ids = ids[: max_length - 1] + [ids[-1]]
    return ids + [pad_id] * (max_length - len(ids))


def token_strings(tokenizer: Tokenizer, text: str) -> List[str]:
    """Per-token decoded strings for the interior (non-special) tokens,
    with the CLIP end-of-word marker ``</w>`` stripped so accumulated
    lengths line up with the raw words."""
    ids = tokenizer.encode(text)[1:-1]
    out = []
    for tok in ids:
        s = tokenizer.decode([tok]).strip("#").replace("</w>", "").strip()
        out.append(s)
    return out


@dataclass
class HashWordTokenizer:
    """Deterministic word-level tokenizer with optional sub-word splitting.

    Words hash into ``[num_special, vocab_size)``; words longer than
    ``split_len`` are split into chunks so that multi-token words exist.
    Decoding is exact via a reverse map populated on encode; unknown ids
    decode to a stable placeholder.
    """

    vocab_size: int = 49408
    model_max_length: int = 77
    split_len: int = 8
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 1  # CLIP pads with EOS
    sequential: bool = False  # collision-free ids, first-seen order
    _reverse: Dict[int, str] = field(default_factory=dict)
    _forward: Dict[str, int] = field(default_factory=dict)

    def _piece_id(self, piece: str) -> int:
        if self.sequential:
            rid = self._forward.get(piece)
            if rid is None:
                rid = 2 + len(self._forward)
                if rid >= self.vocab_size:
                    raise ValueError(
                        f"HashWordTokenizer vocab exhausted at {piece!r}")
                self._forward[piece] = rid
                self._reverse[rid] = piece
            return rid
        h = hashlib.sha1(piece.encode("utf-8")).digest()
        rid = 2 + int.from_bytes(h[:4], "big") % (self.vocab_size - 2)
        prev = self._reverse.setdefault(rid, piece)
        if prev != piece:
            raise ValueError(
                f"HashWordTokenizer id collision: {piece!r} vs {prev!r} (id {rid}); "
                "use a larger vocab_size for this corpus."
            )
        return rid

    def _word_pieces(self, word: str) -> List[str]:
        if len(word) <= self.split_len:
            return [word]
        return [word[i : i + self.split_len] for i in range(0, len(word), self.split_len)]

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_token_id]
        for word in text.lower().split():
            for piece in self._word_pieces(word):
                ids.append(self._piece_id(piece))
        ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        parts = []
        for i in ids:
            if i == self.bos_token_id or i == self.eos_token_id:
                continue
            parts.append(self._reverse.get(int(i), f"<unk{int(i)}>"))
        return " ".join(parts)

    def __call__(self, texts, padding: str = "max_length", max_length: Optional[int] = None,
                 truncation: bool = True):
        """HF-style batch call returning ``{'input_ids': [[int]]}``."""
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        batch = [pad_ids(self.encode(t), max_length, self.pad_token_id) for t in texts]
        return {"input_ids": batch}
