"""Tokenizers (copied from pipeinfer_tpu.tokenizer; ref: llama.cpp
llm_tokenizer_spm/bpe, vocab :1340-1389)."""

from .vocab import Vocab, tokenizer_from_gguf  # noqa: F401
