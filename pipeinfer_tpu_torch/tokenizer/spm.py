"""SentencePiece-style tokenizer (llama family).

Independent implementation of the reference's SPM algorithm
(ref: llama.cpp `llm_tokenizer_spm::tokenize`): greedy highest-score bigram
merging over UTF-8 character symbols, with byte fallback for symbols not in
the vocabulary, whitespace escaping to U+2581, and a prepended space.
Special (control/user-defined) tokens are split out before tokenization,
mirroring the special-token cache partitioning.
"""

from __future__ import annotations

import heapq

from .vocab import TokenType, Vocab

_WS = "▁"  # ▁


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab.tokens)}
        self.byte_tokens = {}
        for i, (t, tt) in enumerate(zip(vocab.tokens, vocab.token_types)):
            if tt == TokenType.BYTE and len(t) == 6 and t.startswith("<0x"):
                self.byte_tokens[int(t[3:5], 16)] = i
        self.special = {
            t: i
            for i, (t, tt) in enumerate(zip(vocab.tokens, vocab.token_types))
            if tt in (TokenType.CONTROL, TokenType.USER_DEFINED) and t
        }

    # -- encoding -----------------------------------------------------------

    def _merge_piece(self, text: str) -> list[int]:
        """Greedy bigram merge of one raw-text piece."""
        if not text:
            return []
        symbols = [c for c in text]  # utf-8 characters

        # priority queue of candidate merges: (-score, left_index, merged_str)
        # linked-list over symbol slots (None = merged away)
        nxt = list(range(1, len(symbols))) + [-1]
        prv = [-1] + list(range(len(symbols) - 1))
        alive = [True] * len(symbols)

        def try_add(heap, i):
            j = nxt[i]
            if i < 0 or j < 0:
                return
            merged = symbols[i] + symbols[j]
            tid = self.token_to_id.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-self.vocab.scores[tid], i, merged))

        heap: list = []
        for i in range(len(symbols) - 1):
            try_add(heap, i)

        while heap:
            _, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j < 0 or not alive[j] or symbols[i] + symbols[j] != merged:
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            try_add(heap, prv[i] if prv[i] >= 0 else -1)
            try_add(heap, i)

        out: list[int] = []
        i = 0
        while i >= 0:
            if alive[i]:
                sym = symbols[i]
                tid = self.token_to_id.get(sym)
                if tid is not None:
                    out.append(tid)
                else:
                    # byte fallback (ref: llm_tokenizer_spm resegment)
                    for b in sym.encode("utf-8"):
                        out.append(self.byte_tokens.get(b, self.vocab.unk_id))
            i = nxt[i]
        return out

    def encode(self, text: str, add_bos: bool | None = None, special: bool = True) -> list[int]:
        out: list[int] = []
        if add_bos is None:
            add_bos = self.vocab.add_bos
        if add_bos:
            out.append(self.vocab.bos_id)
        if not text:
            return out

        # split on special tokens first
        pieces: list[tuple[str, int | None]] = [(text, None)]
        if special and self.special:
            for tok, tid in sorted(self.special.items(), key=lambda kv: -len(kv[0])):
                new_pieces: list[tuple[str, int | None]] = []
                for piece, pid in pieces:
                    if pid is not None:
                        new_pieces.append((piece, pid))
                        continue
                    parts = piece.split(tok)
                    for n, part in enumerate(parts):
                        if n:
                            new_pieces.append((tok, tid))
                        if part:
                            new_pieces.append((part, None))
                pieces = new_pieces

        first_raw = True
        for piece, pid in pieces:
            if pid is not None:
                out.append(pid)
                continue
            # whitespace escaping; leading space on the first raw piece
            # (ref: llama_tokenize_internal raw_text = " " + raw_text)
            esc = piece.replace(" ", _WS)
            if first_raw:
                esc = _WS + esc
                first_raw = False
            out.extend(self._merge_piece(esc))
        if self.vocab.add_eos:
            out.append(self.vocab.eos_id)
        return out

    # -- decoding -----------------------------------------------------------

    def piece_bytes(self, token_id: int) -> bytes:
        """Token -> raw piece bytes (ref: llama_token_to_piece — byte
        tokens return the raw byte, so multi-byte UTF-8 characters split
        across byte tokens reassemble correctly)."""
        tt = self.vocab.token_types[token_id]
        t = self.vocab.tokens[token_id]
        if tt == TokenType.BYTE:
            return bytes([int(t[3:5], 16)])
        if tt == TokenType.CONTROL:
            return b""
        return t.replace(_WS, " ").encode("utf-8")

    def piece(self, token_id: int) -> str:
        """Token -> display text. Lossy for split UTF-8 byte tokens —
        streaming callers should use tokenizer.stream.StreamDecoder."""
        return self.piece_bytes(token_id).decode("utf-8", errors="replace")

    def decode(self, ids: list[int]) -> str:
        # byte tokens must be merged at the byte level to re-form utf-8
        buf = bytearray()
        for tid in ids:
            tt = self.vocab.token_types[tid]
            t = self.vocab.tokens[tid]
            if tt == TokenType.BYTE:
                buf.append(int(t[3:5], 16))
            elif tt == TokenType.CONTROL:
                pass
            else:
                buf.extend(t.replace(_WS, " ").encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
