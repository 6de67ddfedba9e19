from .tokenizer import HashWordTokenizer, Tokenizer, pad_ids, token_strings

__all__ = ["HashWordTokenizer", "Tokenizer", "pad_ids", "token_strings"]
