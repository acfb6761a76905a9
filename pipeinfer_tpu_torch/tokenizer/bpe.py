"""Byte-level BPE tokenizer (falcon/mpt/starcoder/gpt-neox families).

Independent implementation of the reference's BPE path
(ref: llama.cpp llm_tokenizer_bpe): GPT-2 regex pre-tokenization, the
byte↔unicode printable mapping, then lowest-rank merge loops using the
GGUF-embedded merges list (tokenizer.ggml.merges).

Copied from pipeinfer_tpu.tokenizer.bpe, with one change: the ``regex``
package (for the pattern's Unicode classes) is imported when a BPE
tokenizer is built, not when the module is imported, so the port and its
SPM (llama) vocabularies never need it.
"""

from __future__ import annotations

import functools

from .vocab import TokenType, Vocab

# GPT-2 pre-tokenization pattern (public constant)
_PAT_SRC = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@functools.lru_cache(maxsize=1)
def _pattern():
    import regex

    return regex.compile(_PAT_SRC)


def _bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte → printable-unicode table (public algorithm)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_B2U = _bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._pat = _pattern()
        self.token_to_id = {t: i for i, t in enumerate(vocab.tokens)}
        self.merge_rank = {}
        for rank, merge in enumerate(vocab.merges):
            a, _, b = merge.partition(" ")
            self.merge_rank[(a, b)] = rank
        self.special = {
            t: i
            for i, (t, tt) in enumerate(zip(vocab.tokens, vocab.token_types))
            if tt in (TokenType.CONTROL, TokenType.USER_DEFINED) and t
        }

    def _bpe_word(self, word: str) -> list[str]:
        parts = [c for c in word]
        while len(parts) > 1:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.merge_rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best = i
            if best is None:
                break
            parts = parts[:best] + [parts[best] + parts[best + 1]] + parts[best + 2 :]
        return parts

    def encode(self, text: str, add_bos: bool | None = None, special: bool = True) -> list[int]:
        out: list[int] = []
        if add_bos is None:
            add_bos = self.vocab.add_bos
        if add_bos and self.vocab.bos_id >= 0:
            out.append(self.vocab.bos_id)
        if not text:
            return out

        pieces: list[tuple[str, int | None]] = [(text, None)]
        if special and self.special:
            for tok, tid in sorted(self.special.items(), key=lambda kv: -len(kv[0])):
                nxt: list[tuple[str, int | None]] = []
                for piece, pid in pieces:
                    if pid is not None:
                        nxt.append((piece, pid))
                        continue
                    parts = piece.split(tok)
                    for n, part in enumerate(parts):
                        if n:
                            nxt.append((tok, tid))
                        if part:
                            nxt.append((part, None))
                pieces = nxt

        for piece, pid in pieces:
            if pid is not None:
                out.append(pid)
                continue
            for m in self._pat.findall(piece):
                mapped = "".join(_B2U[b] for b in m.encode("utf-8"))
                for part in self._bpe_word(mapped):
                    tid = self.token_to_id.get(part)
                    if tid is not None:
                        out.append(tid)
                    else:
                        for ch in part:
                            tid = self.token_to_id.get(ch)
                            if tid is not None:
                                out.append(tid)
                            elif self.vocab.unk_id >= 0:
                                out.append(self.vocab.unk_id)
        if self.vocab.add_eos and self.vocab.eos_id >= 0:
            out.append(self.vocab.eos_id)
        return out

    def piece_bytes(self, token_id: int) -> bytes:
        """Token -> raw piece bytes (ref: llama_token_to_piece)."""
        t = self.vocab.tokens[token_id]
        if self.vocab.token_types[token_id] == TokenType.CONTROL:
            return b""
        try:
            return bytes(_U2B[c] for c in t)
        except KeyError:
            return t.encode("utf-8")

    def piece(self, token_id: int) -> str:
        """Token -> display text. Lossy for tokens holding partial UTF-8 —
        streaming callers should use tokenizer.stream.StreamDecoder."""
        return self.piece_bytes(token_id).decode("utf-8", errors="replace")

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for tid in ids:
            t = self.vocab.tokens[tid]
            if self.vocab.token_types[tid] == TokenType.CONTROL:
                continue
            try:
                buf.extend(bytes(_U2B[c] for c in t))
            except KeyError:
                buf.extend(t.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
