"""Grammar-constrained sampling: a PDA over GBNF rules.

Independent re-implementation of the reference's grammar engine
(ref: llama.cpp llama_grammar — stack advancement, char-class matching,
token rejection; exercised by tests/test-llama-grammar.cpp): the grammar
state is a set of PDA stacks of rule positions; accepting a token walks its
codepoints through every stack; `mask_logits` rejects tokens that cannot
advance any stack (with a first-codepoint pre-filter to keep the Python
loop off the hot path for most of the vocabulary).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .gbnf_parser import El, Grammar, parse_gbnf

Frame = tuple[int, int]  # (rule id, element index)
Stack = tuple[Frame, ...]


def _alternate_starts(elems) -> list[int]:
    starts = [0]
    for i, el in enumerate(elems):
        if el.type == El.ALT:
            starts.append(i + 1)
    return starts


class _Machine:
    """Immutable grammar machine with stack algebra."""

    def __init__(self, grammar: Grammar):
        self.g = grammar
        self._class_cache: dict[Frame, tuple[tuple[tuple[int, int], ...], bool, int]] = {}

    def char_class(self, frame: Frame):
        """Char-matcher at frame -> (ranges, negated, next index)."""
        hit = self._class_cache.get(frame)
        if hit is not None:
            return hit
        rid, i = frame
        els = self.g.rules[rid]
        base = els[i]
        ranges = []
        j = i
        lo = els[j].value
        j += 1
        if j < len(els) and els[j].type == El.CHAR_RNG_UPPER:
            ranges.append((lo, els[j].value))
            j += 1
        else:
            ranges.append((lo, lo))
        while j < len(els) and els[j].type == El.CHAR_ALT:
            lo = els[j].value
            j += 1
            if j < len(els) and els[j].type == El.CHAR_RNG_UPPER:
                ranges.append((lo, els[j].value))
                j += 1
            else:
                ranges.append((lo, lo))
        out = (tuple(ranges), base.type == El.CHAR_NOT, j)
        self._class_cache[frame] = out
        return out

    def expand(self, stack: Stack) -> list[Stack]:
        """Advance until the top frame is a char matcher (or stack empty),
        expanding rule refs / popping completed alternates
        (ref: llama_grammar_advance_stack)."""
        if not stack:
            return [stack]
        rid, i = stack[-1]
        el = self.g.rules[rid][i]
        if el.type in (El.CHAR, El.CHAR_NOT):
            return [stack]
        if el.type in (El.END, El.ALT):
            return self.expand(stack[:-1])
        if el.type == El.RULE_REF:
            cont = stack[:-1] + (((rid, i + 1)),)
            out: list[Stack] = []
            sub = self.g.rules[el.value]
            for start in _alternate_starts(sub):
                out.extend(self.expand(cont + ((el.value, start),)))
            return out
        raise AssertionError(el)

    def init_stacks(self) -> list[Stack]:
        out: list[Stack] = []
        for start in _alternate_starts(self.g.rules[self.g.root_id]):
            out.extend(self.expand(((self.g.root_id, start),)))
        return _dedupe(out)

    def accept_char(self, stacks: list[Stack], cp: int) -> list[Stack]:
        out: list[Stack] = []
        for st in stacks:
            if not st:
                continue
            ranges, negated, nxt = self.char_class(st[-1])
            matched = any(lo <= cp <= hi for lo, hi in ranges)
            if matched != negated:
                rid, _ = st[-1]
                out.extend(self.expand(st[:-1] + ((rid, nxt),)))
        return _dedupe(out)

    def can_accept_seq(self, stacks: list[Stack], cps: list[int]) -> bool:
        for cp in cps:
            stacks = self.accept_char(stacks, cp)
            if not stacks:
                return False
        return True


def _dedupe(stacks: list[Stack]) -> list[Stack]:
    seen = set()
    out = []
    for s in stacks:
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def _utf8_walk(buf: bytes):
    """Decode a byte string into (codepoints, incomplete_tail) or None if the
    bytes are not valid UTF-8 (the reference's decode_utf8 with partial
    carry, llama.cpp grammar partial_utf8 handling)."""
    cps: list[int] = []
    i, n = 0, len(buf)
    while i < n:
        b0 = buf[i]
        if b0 < 0x80:
            need = 1
        elif b0 >= 0xF0:
            need = 4
        elif b0 >= 0xE0:
            need = 3
        elif b0 >= 0xC0:
            need = 2
        else:
            return None  # stray continuation byte
        if i + need > n:
            # incomplete tail: bytes present so far must still be a valid
            # prefix (lead + continuation bytes only), like the reference's
            # decode_utf8 which rejects bad continuations immediately
            if any(not 0x80 <= b <= 0xBF for b in buf[i + 1 :]):
                return None
            return cps, buf[i:]
        try:
            cps.append(ord(buf[i : i + need].decode("utf-8")))
        except UnicodeDecodeError:
            return None
        i += need
    return cps, b""


@dataclasses.dataclass
class GrammarState:
    """Mutable per-sequence grammar sampler state; copyable for async-run
    snapshots (ref: llama_grammar_copy).

    Token pieces are matched byte-accurately: a byte-fallback token holding
    the lead byte of a multi-byte UTF-8 character leaves its bytes in
    ``partial`` until continuation tokens complete the codepoint (the
    reference's grammar partial_utf8 state)."""

    machine: _Machine
    stacks: list[Stack]
    token_bytes: list[bytes]  # vocab id -> raw piece bytes
    token_cps: list[list[int]]  # complete-codepoint prefix of each piece
    token_tail: list[bytes]  # incomplete utf-8 tail of each piece (b"" = none)
    eos_id: int
    partial: bytes = b""  # carried incomplete utf-8 sequence

    @classmethod
    def from_gbnf(cls, text: str, token_pieces, eos_id: int) -> "GrammarState":
        m = _Machine(parse_gbnf(text))
        tb = [p if isinstance(p, bytes) else p.encode("utf-8") for p in token_pieces]
        cps, tails = [], []
        for b in tb:
            walked = _utf8_walk(b)
            if walked is None:  # not UTF-8 at all: never matchable mid-char
                cps.append([])
                tails.append(b"\xff")  # poison: invalid as any continuation
            else:
                cps.append(walked[0])
                tails.append(walked[1])
        return cls(
            machine=m,
            stacks=m.init_stacks(),
            token_bytes=tb,
            token_cps=cps,
            token_tail=tails,
            eos_id=eos_id,
        )

    def copy(self) -> "GrammarState":
        return GrammarState(
            self.machine, list(self.stacks), self.token_bytes,
            self.token_cps, self.token_tail, self.eos_id, self.partial,
        )

    def reset(self):
        self.stacks = self.machine.init_stacks()
        self.partial = b""

    @property
    def complete(self) -> bool:
        return not self.partial and any(not s for s in self.stacks)

    def _walk_token(self, token_id: int):
        """Effective (codepoints, new_partial) of a token in the current
        partial-utf8 state, or None if the bytes are invalid here."""
        if not self.partial:
            tail = self.token_tail[token_id]
            if tail == b"\xff":
                return None
            return self.token_cps[token_id], tail
        return _utf8_walk(self.partial + self.token_bytes[token_id])

    def accept_token(self, token_id: int):
        if token_id == self.eos_id:
            return
        walked = self._walk_token(token_id)
        if walked is None:
            raise ValueError(f"token {token_id} is not valid UTF-8 here")
        cps, self.partial = walked
        for cp in cps:
            self.stacks = self.machine.accept_char(self.stacks, cp)
            if not self.stacks:
                raise ValueError(f"token {token_id} violates grammar")

    def allows_token(self, token_id: int) -> bool:
        if token_id == self.eos_id:
            return self.complete
        walked = self._walk_token(token_id)
        if walked is None:
            return False
        cps, _tail = walked
        if not cps and not _tail:
            return False
        # cps must advance the machine; an incomplete tail is optimistically
        # allowed (its codepoint is checked when a later token completes it)
        return self.machine.can_accept_seq(self.stacks, cps)

    def mask_logits(self, logits: np.ndarray) -> np.ndarray:
        """-inf for tokens the grammar rejects (ref: llama_sample_grammar).

        Pre-filters by first codepoint: compute the allowed-first-cp set
        once, then fully walk only tokens that pass."""
        out = logits.copy()
        live = [s for s in self.stacks if s]
        # allowed first-cp test via the (few) distinct char classes on top
        tops = {s[-1] for s in live}
        classes = [self.machine.char_class(t) for t in tops]

        def first_ok(cp: int) -> bool:
            for ranges, negated, _ in classes:
                m = any(lo <= cp <= hi for lo, hi in ranges)
                if m != negated:
                    return True
            return False

        first_cache: dict[int, bool] = {}
        for tid in range(min(len(self.token_cps), len(logits))):
            if tid == self.eos_id:
                if not self.complete:
                    out[tid] = -np.inf
                continue
            cps = self.token_cps[tid]
            if not cps:
                out[tid] = -np.inf
                continue
            c0 = cps[0]
            ok0 = first_cache.get(c0)
            if ok0 is None:
                ok0 = first_ok(c0)
                first_cache[c0] = ok0
            if not ok0:
                out[tid] = -np.inf
                continue
            if len(cps) > 1 and not self.machine.can_accept_seq(self.stacks, cps):
                out[tid] = -np.inf
        return out


def grammar_state_from_gbnf(text: str, tokenizer) -> GrammarState:
    pieces = [tokenizer.piece_bytes(i) for i in range(tokenizer.vocab.n_vocab)]
    return GrammarState.from_gbnf(text, pieces, tokenizer.vocab.eos_id)
