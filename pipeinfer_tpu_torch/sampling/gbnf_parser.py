"""GBNF grammar parser.

Independent implementation of the reference's grammar format
(ref: grammar-parser.cpp behavior; grammars/*.gbnf syntax):

    rule-name ::= alternates
    alternates: sequences separated by '|'
    elements: "literal", [char-class] (ranges, ^negation), rule-ref,
              ( group ), postfix * + ?, escapes \\x \\u \\t \\n \\r,
              # comments

Rules compile to the same element machine the reference uses: flat lists of
(type, value) ops per alternate, consumed by the PDA in sampling.grammar.
"""

from __future__ import annotations

import dataclasses
import enum


class El(enum.IntEnum):
    """ref: llama_gretype (llama.h grammar element types)."""

    END = 0
    ALT = 1
    RULE_REF = 2
    CHAR = 3
    CHAR_NOT = 4
    CHAR_RNG_UPPER = 5
    CHAR_ALT = 6


@dataclasses.dataclass(frozen=True)
class Elem:
    type: El
    value: int = 0  # codepoint or rule id


@dataclasses.dataclass
class Grammar:
    rules: list[list[Elem]]  # rule id -> flat element list (alternates inline)
    root_id: int
    names: dict[str, int]


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.names: dict[str, int] = {}
        self.rules: dict[int, list[Elem]] = {}

    # -- lexing helpers -----------------------------------------------------

    def _ws(self, newlines: bool = True):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                break

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _name(self) -> str:
        start = self.pos
        while (c := self._peek()) and (c.isalnum() or c in "-_"):
            self.pos += 1
        if start == self.pos:
            raise ValueError(f"expected name at {self.text[self.pos:self.pos+20]!r}")
        return self.text[start : self.pos]

    def _rule_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.names)
        return self.names[name]

    def _char(self) -> int:
        """One (possibly escaped) character -> codepoint."""
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return ord(c)
        e = self.text[self.pos]
        self.pos += 1
        if e == "x":
            v = int(self.text[self.pos : self.pos + 2], 16)
            self.pos += 2
            return v
        if e == "u":
            v = int(self.text[self.pos : self.pos + 4], 16)
            self.pos += 4
            return v
        if e == "U":
            v = int(self.text[self.pos : self.pos + 8], 16)
            self.pos += 8
            return v
        return {"t": 9, "n": 10, "r": 13}.get(e, ord(e))

    # -- grammar ------------------------------------------------------------

    def parse(self) -> Grammar:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if "root" not in self.names:
            raise ValueError("grammar has no 'root' rule")
        n = len(self.names)
        rules = [self.rules.get(i, [Elem(El.END)]) for i in range(max(n, max(self.rules) + 1))]
        return Grammar(rules=rules, root_id=self.names["root"], names=dict(self.names))

    def _parse_rule(self):
        name = self._name()
        self._ws()
        if self.text[self.pos : self.pos + 3] != "::=":
            raise ValueError(f"expected ::= after {name!r}")
        self.pos += 3
        self._ws()
        rid = self._rule_id(name)
        elems = self._parse_alternates(name, nested=False)
        self.rules[rid] = elems

    def _parse_alternates(self, base: str, nested: bool) -> list[Elem]:
        out: list[Elem] = []
        out.extend(self._parse_sequence(base, nested))
        self._ws(newlines=nested)
        while self._peek() == "|":
            self.pos += 1
            self._ws()
            out.append(Elem(El.ALT))
            out.extend(self._parse_sequence(base, nested))
            self._ws(newlines=nested)
        out.append(Elem(El.END))
        return out

    def _fresh_rule(self, base: str, elems: list[Elem]) -> int:
        rid = self._rule_id(f"{base}_{len(self.names)}")
        self.rules[rid] = elems
        return rid

    def _parse_sequence(self, base: str, nested: bool = False) -> list[Elem]:
        seq: list[Elem] = []
        while True:
            self._ws(newlines=nested)
            c = self._peek()
            if c == '"':
                last = self._parse_literal()
            elif c == "[":
                last = self._parse_char_class()
            elif c == "(":
                self.pos += 1
                self._ws()
                inner = self._parse_alternates(base, nested=True)
                if self._peek() != ")":
                    raise ValueError("expected )")
                self.pos += 1
                rid = self._fresh_rule(base, inner)
                last = [Elem(El.RULE_REF, rid)]
            elif c and (c.isalnum() or c in "-_"):
                save = self.pos
                name = self._name()
                self._ws(newlines=False)  # '::=' lookahead must stay on-line
                if self.text[self.pos : self.pos + 3] == "::=":
                    self.pos = save  # start of the next rule
                    break
                last = [Elem(El.RULE_REF, self._rule_id(name))]
            else:
                break

            # postfix operators
            op = self._peek()
            if op and op in "*+?":
                self.pos += 1
                rid_ref = None
                if op == "*":
                    # S -> last S | ε
                    rid_ref = self._rule_id(f"{base}_{len(self.names)}")
                    self.rules[rid_ref] = [*last, Elem(El.RULE_REF, rid_ref), Elem(El.ALT), Elem(El.END)]
                    seq.append(Elem(El.RULE_REF, rid_ref))
                elif op == "+":
                    # S -> last S | last
                    rid_ref = self._rule_id(f"{base}_{len(self.names)}")
                    self.rules[rid_ref] = [*last, Elem(El.RULE_REF, rid_ref), Elem(El.ALT), *last, Elem(El.END)]
                    seq.append(Elem(El.RULE_REF, rid_ref))
                else:  # ?
                    rid_ref = self._rule_id(f"{base}_{len(self.names)}")
                    self.rules[rid_ref] = [*last, Elem(El.ALT), Elem(El.END)]
                    seq.append(Elem(El.RULE_REF, rid_ref))
            else:
                seq.extend(last)
        return seq

    def _parse_literal(self) -> list[Elem]:
        assert self._peek() == '"'
        self.pos += 1
        out: list[Elem] = []
        while self._peek() != '"':
            if self.pos >= len(self.text):
                raise ValueError("unterminated literal")
            out.append(Elem(El.CHAR, self._char()))
        self.pos += 1
        return out

    def _parse_char_class(self) -> list[Elem]:
        assert self._peek() == "["
        self.pos += 1
        negated = self._peek() == "^"
        if negated:
            self.pos += 1
        out: list[Elem] = []
        first = True
        while self._peek() != "]":
            if self.pos >= len(self.text):
                raise ValueError("unterminated char class")
            lo = self._char()
            t = El.CHAR_NOT if (negated and first) else (El.CHAR if first else El.CHAR_ALT)
            out.append(Elem(t, lo))
            first = False
            if self._peek() == "-" and self.text[self.pos + 1] != "]":
                self.pos += 1
                hi = self._char()
                out.append(Elem(El.CHAR_RNG_UPPER, hi))
        self.pos += 1
        return out


def parse_gbnf(text: str) -> Grammar:
    return _Parser(text).parse()
