"""JSON schema -> GBNF grammar converter.

Counterpart of the reference's `examples/json-schema-to-grammar.py`
(same CLI role: emit a grammar for --grammar-file / the `grammar` field of
a server request that constrains generation to schema-conforming JSON).
Feature surface matches the reference — oneOf/anyOf, const, enum,
object.properties with --prop-order, array.items, the primitive types,
the single-space `space` rule, rule-name sanitization and dedup — and
closes its marked TODOs: `required` (optional properties get an optional
tail grammar), `prefixItems` (tuple arrays), bounded `minItems`/`maxItems`
repetition, and `$ref` into `#/$defs` / `#/definitions`.

Usage: python -m pipeinfer_tpu_torch.tools.json_schema schema.json > out.gbnf

A copy of pipeinfer_tpu.tools.json_schema, which imports no JAX: the same
grammar text for the same schema.
"""

from __future__ import annotations

import json
import re

# One optional space: JSON whitespace is unbounded, but letting the model
# emit arbitrary runs of whitespace invites runaway generations.
_SPACE = '" "?'

_PRIMITIVES = {
    "boolean": '("true" | "false") space',
    "null": '"null" space',
    "integer": '"-"? ("0" | [1-9] [0-9]*) space',
    "number": '"-"? ("0" | [1-9] [0-9]*) ("." [0-9]+)? ([eE] [-+]? [0-9]+)? space',
    "string": '"\\"" ([^"\\\\] | "\\\\" (["\\\\/bfnrt] | "u" [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F] [0-9a-fA-F]))* "\\"" space',
}

_NAME_BAD = re.compile(r"[^a-zA-Z0-9-]+")  # chars not allowed in rule names


def _literal(value) -> str:
    """A JSON value as a quoted GBNF literal: the model emits the value's
    JSON text verbatim (including string delimiters), so every backslash
    and quote of that text must be GBNF-escaped."""
    text = json.dumps(value)
    esc = text.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{esc}"'


class SchemaToGBNF:
    def __init__(self, prop_order: list[str] | None = None, root_schema=None):
        self.rules: dict[str, str] = {"space": _SPACE}
        self.prop_order = {k: i for i, k in enumerate(prop_order or [])}
        self.root_schema = root_schema
        self._ref_rule: dict[str, str] = {}  # $ref path -> rule name

    # -- rule table ----------------------------------------------------------

    def _put(self, name: str, body: str) -> str:
        key = _NAME_BAD.sub("-", name) or "rule"
        if key in self.rules and self.rules[key] != body:
            n = 0
            while f"{key}{n}" in self.rules and self.rules[f"{key}{n}"] != body:
                n += 1
            key = f"{key}{n}"
        self.rules[key] = body
        return key

    # -- repetition helper ---------------------------------------------------

    def _repeat(self, item: str, lo: int, hi: int | None) -> str:
        """`lo..hi` comma-separated items (JSON array interior)."""
        more = f'("," space {item})'
        if hi is None:
            if lo == 0:
                return f"({item} {more}*)?"
            return " ".join([item] + [more] * (lo - 1)) + f" {more}*"
        if hi == 0:
            return '""'
        # bounded: max(lo,1) required, then nested-optional tails up to hi
        opt = ""
        for _ in range(hi - max(lo, 1)):
            opt = f"({more}{(' ' + opt) if opt else ''})?"
        core = " ".join([item] + [more] * (max(lo, 1) - 1) + ([opt] if opt else []))
        return core if lo >= 1 else f"({core})?"

    # -- visitor -------------------------------------------------------------

    def _resolve_ref(self, ref: str):
        if not ref.startswith("#/"):
            raise ValueError(f"only local $ref supported, got {ref}")
        node = self.root_schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node, ref.split("/")[-1]

    def convert(self, schema: dict, name: str = "root") -> str:
        if "$ref" in schema:
            ref = schema["$ref"]
            # memoize per $ref path so recursive schemas (linked lists,
            # trees — the primary $defs use case) emit ONE named rule that
            # references itself instead of inlining forever
            if ref in self._ref_rule:
                return self._ref_rule[ref]
            target, ref_name = self._resolve_ref(ref)
            key = _NAME_BAD.sub("-", ref_name) or "ref"
            while key in self.rules:
                key += "-r"
            self._ref_rule[ref] = key
            real = self.convert(target, key)
            if real != key:
                self.rules[key] = real  # alias (target was a primitive)
            return key

        for combo in ("oneOf", "anyOf"):
            if combo in schema:
                alts = [
                    self.convert(alt, f"{name}-{i}")
                    for i, alt in enumerate(schema[combo])
                ]
                return self._put(name, " | ".join(alts))

        if "const" in schema:
            return self._put(name, f"{_literal(schema['const'])} space")
        if "enum" in schema:
            alts = " | ".join(_literal(v) for v in schema["enum"])
            return self._put(name, f"({alts}) space")

        stype = schema.get("type")

        if stype == "object" and "properties" in schema:
            required = set(schema.get("required", schema["properties"].keys()))
            pairs = sorted(
                schema["properties"].items(),
                key=lambda kv: (self.prop_order.get(kv[0], len(self.prop_order)), kv[0]),
            )
            req = [(k, v) for k, v in pairs if k in required]
            opt = [(k, v) for k, v in pairs if k not in required]

            def kv_rule(key: str, sub) -> str:
                sub_name = self.convert(sub, f"{name}-{key}")
                return f'{_literal(key)} space ":" space {sub_name}'

            opt_kv = [kv_rule(k, v) for k, v in opt]
            # optional properties trail the required ones in a fixed order
            # (closes the reference's `required` TODO with a linear-size
            # grammar). With required props, each optional is independently
            # comma-prefixed. With NO required props, the first emitted
            # optional must NOT carry a comma: build the right-nested
            # "one of the optionals goes first" chain
            #   (kv_i tail_{i+1} | kv_{i+1} tail_{i+2} | ...)?
            #   tail_j = ("," space kv_j)? tail_{j+1}
            if req:
                body = '"{" space'
                for i, (k, v) in enumerate(req):
                    if i > 0:
                        body += ' "," space'
                    body += " " + kv_rule(k, v)
                for kv in opt_kv:
                    body += f' ("," space {kv})?'
                body += ' "}" space'
            else:
                tails = [""] * (len(opt_kv) + 1)
                for j in range(len(opt_kv) - 1, -1, -1):
                    tails[j] = f' ("," space {opt_kv[j]})?{tails[j + 1]}'
                alts = [f"{kv}{tails[i + 1]}" for i, kv in enumerate(opt_kv)]
                interior = f" ({' | '.join(alts)})?" if alts else ""
                body = f'"{{" space{interior} "}}" space'
            return self._put(name, body)

        if stype == "array":
            if "prefixItems" in schema:
                items = [
                    self.convert(s, f"{name}-{i}")
                    for i, s in enumerate(schema["prefixItems"])
                ]
                inner = ' "," space '.join(items)
                return self._put(name, f'"[" space {inner} "]" space')
            item = self.convert(schema.get("items", {}), f"{name}-item")
            lo = int(schema.get("minItems", 0))
            hi = schema.get("maxItems")
            hi = int(hi) if hi is not None else None
            interior = self._repeat(item, lo, hi)
            return self._put(name, f'"[" space {interior} "]" space')

        if stype in _PRIMITIVES:
            key = name if name == "root" else stype
            return self._put(key, _PRIMITIVES[stype])

        if stype is None and not schema:
            # unconstrained: any JSON value
            return self._put(name, self._any_value())

        raise ValueError(f"unsupported schema node: {schema}")

    def _any_value(self) -> str:
        for t in ("boolean", "null", "integer", "number", "string"):
            self._put(t, _PRIMITIVES[t])
        self._put(
            "any-array", '"[" space (any-value ("," space any-value)*)? "]" space'
        )
        self._put(
            "any-object",
            '"{" space (string ":" space any-value ("," space string ":" space any-value)*)? "}" space',
        )
        self._put(
            "any-value",
            "boolean | null | number | string | any-array | any-object",
        )
        return "any-value"

    def gbnf(self) -> str:
        lines = [f"{k} ::= {v}" for k, v in self.rules.items() if k != "root"]
        return "\n".join([f"root ::= {self.rules['root']}"] + lines) + "\n"


def schema_to_gbnf(schema: dict, prop_order: list[str] | None = None) -> str:
    conv = SchemaToGBNF(prop_order, root_schema=schema)
    key = conv.convert(schema, "root")
    if key != "root":
        conv.rules["root"] = key  # root aliases the ref/primitive rule
    return conv.gbnf()


def main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Emit a GBNF grammar that constrains generation to "
        "JSON conforming to the given schema (ref: examples/"
        "json-schema-to-grammar.py)."
    )
    ap.add_argument("schema", help="path to a JSON schema file, or - for stdin")
    ap.add_argument("--prop-order", default="",
                    help="comma-separated property precedence")
    args = ap.parse_args(argv)
    text = sys.stdin.read() if args.schema == "-" else open(args.schema).read()
    order = [s for s in args.prop_order.split(",") if s]
    print(schema_to_gbnf(json.loads(text), order), end="")


if __name__ == "__main__":
    main()
