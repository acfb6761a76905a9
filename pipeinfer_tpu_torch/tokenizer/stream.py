"""UTF-8-safe incremental detokenization for streaming output.

The reference's server buffers incomplete UTF-8 sequences before sending
SSE chunks (ref: examples/server/server.cpp — it checks the pending byte
count of llama_token_to_piece output); CLI drivers get the same behavior
here via StreamDecoder: bytes accumulate and only complete characters are
emitted, so a CJK/emoji character split across SPM byte-fallback tokens
never prints as mojibake.
"""

from __future__ import annotations


def complete_utf8_prefix(buf: bytes) -> int:
    """Length of the longest prefix of `buf` that does not end inside an
    incomplete (but so-far-valid) multi-byte UTF-8 sequence."""
    n = len(buf)
    # find the last lead byte within the final 3 bytes
    i = n - 1
    while i >= 0 and i >= n - 3 and 0x80 <= buf[i] <= 0xBF:
        i -= 1
    if i < 0 or i < n - 3:
        return n  # not a trailing partial sequence; let decode handle it
    b0 = buf[i]
    if b0 >= 0xF8:
        return n  # invalid lead byte; pass through for decode to replace
    if b0 >= 0xF0:
        need = 4
    elif b0 >= 0xE0:
        need = 3
    elif b0 >= 0xC0:
        need = 2
    else:
        return n
    return i if n - i < need else n


class StreamDecoder:
    """Accumulates token piece bytes; emits only complete UTF-8 text."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.buf = bytearray()

    def feed(self, token_id: int) -> str:
        self.buf += self.tok.piece_bytes(token_id)
        cut = complete_utf8_prefix(bytes(self.buf))
        out = bytes(self.buf[:cut]).decode("utf-8", errors="replace")
        del self.buf[:cut]
        return out

    def flush(self) -> str:
        out = bytes(self.buf).decode("utf-8", errors="replace")
        self.buf.clear()
        return out
