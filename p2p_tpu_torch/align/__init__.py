from .aligner import (
    get_refinement_mapper,
    get_replacement_mapper,
    needleman_wunsch,
    refinement_mapper_single,
    replacement_mapper_single,
)
from .words import (
    get_equalizer,
    get_time_words_attention_alpha,
    get_word_inds,
    update_alpha_time_word,
)

__all__ = [
    "get_refinement_mapper",
    "get_replacement_mapper",
    "needleman_wunsch",
    "refinement_mapper_single",
    "replacement_mapper_single",
    "get_equalizer",
    "get_time_words_attention_alpha",
    "get_word_inds",
    "update_alpha_time_word",
]
