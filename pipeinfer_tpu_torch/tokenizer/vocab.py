"""Vocabulary + tokenizer construction from GGUF metadata
(ref: llama.cpp:2387-2682 `llm_load_vocab`)."""

from __future__ import annotations

import dataclasses
from enum import IntEnum

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader


class TokenType(IntEnum):
    """ref: llama_token_type in llama.h."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


@dataclasses.dataclass
class Vocab:
    model: str  # "llama" (SPM) | "gpt2" (BPE)
    tokens: list[str]
    scores: list[float]
    token_types: list[int]
    merges: list[str]
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    fim_pre: int = -1  # fill-in-middle specials (ref: llama_token_prefix etc.)
    fim_suf: int = -1
    fim_mid: int = -1

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)


def vocab_from_gguf(r: GGUFReader) -> Vocab:
    md = r.metadata
    tokens = list(md[Keys.TOKENIZER_LIST])
    scores = list(md.get(Keys.TOKENIZER_SCORES, [0.0] * len(tokens)))
    ttypes = [int(t) for t in md.get(Keys.TOKENIZER_TOKEN_TYPE, [1] * len(tokens))]
    model = str(md.get(Keys.TOKENIZER_MODEL, "llama"))
    return Vocab(
        model=model,
        tokens=tokens,
        scores=[float(s) for s in scores],
        token_types=ttypes,
        merges=list(md.get(Keys.TOKENIZER_MERGES, [])),
        bos_id=int(md.get(Keys.TOKENIZER_BOS_ID, 1)),
        eos_id=int(md.get(Keys.TOKENIZER_EOS_ID, 2)),
        unk_id=int(md.get(Keys.TOKENIZER_UNK_ID, 0)),
        pad_id=int(md.get(Keys.TOKENIZER_PAD_ID, -1)),
        add_bos=bool(md.get(Keys.TOKENIZER_ADD_BOS, model == "llama")),
        add_eos=bool(md.get(Keys.TOKENIZER_ADD_EOS, False)),
        fim_pre=int(md.get(Keys.TOKENIZER_FIM_PRE, -1)),
        fim_suf=int(md.get(Keys.TOKENIZER_FIM_SUF, -1)),
        fim_mid=int(md.get(Keys.TOKENIZER_FIM_MID, -1)),
    )


def tokenizer_from_gguf(r: GGUFReader):
    vocab = vocab_from_gguf(r)
    if vocab.model == "llama":
        from .spm import SPMTokenizer

        return SPMTokenizer(vocab)
    if vocab.model == "gpt2":
        from .bpe import BPETokenizer

        return BPETokenizer(vocab)
    raise ValueError(f"unknown tokenizer model {vocab.model!r}")
