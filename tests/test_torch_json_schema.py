"""The port's JSON-schema -> GBNF converter (tools/json_schema.py),
mirroring the JAX package's tests/test_json_schema.py: each schema gives
the JAX package's grammar text byte for byte, and the grammar, parsed by
the port's grammar engine, accepts and rejects the same strings; the
checked-in sample grammars parse and match alike."""

from pathlib import Path

import pytest

from pipeinfer_tpu.tools.json_schema import schema_to_gbnf as j_schema_to_gbnf
from pipeinfer_tpu_torch.sampling.gbnf_parser import parse_gbnf
from pipeinfer_tpu_torch.sampling.grammar import _Machine
from pipeinfer_tpu_torch.tools.json_schema import schema_to_gbnf

GRAMMARS_DIR = Path(__file__).resolve().parent.parent / "grammars"


def _accepts(gbnf: str, text: str) -> bool:
    m = _Machine(parse_gbnf(gbnf))
    stacks = m.init_stacks()
    for ch in text:
        stacks = m.accept_char(stacks, ord(ch))
        if not stacks:
            return False
    return any(len(s) == 0 for s in stacks)


SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 2},
        "mode": {"enum": ["fast", "slow"]},
    },
    "required": ["name", "age"],
}

# name -> (schema, schema_to_gbnf keywords, accepted, rejected): the cases of
# test_json_schema.py, one per test there
CASES = {
    "object_schema_accepts_conforming": (SCHEMA, {}, [
        '{ "age" : 3 , "name" : "bo" }', '{ "age" : 41 , "name" : "x" }'], []),
    "object_schema_rejects_wrong_types_and_missing": (SCHEMA, {}, [], [
        '{ "age" : "three" , "name" : "bo" }', '{ "name" : "bo" }',
        '{ "age" : 3 , "name" : "bo" , "mode" : "warp" }']),
    "optional_properties_and_bounds": (SCHEMA, {}, [
        '{ "age" : 1 , "name" : "a" , "tags" : [ ] }',
        '{ "age" : 1 , "name" : "a" , "tags" : [ "x" , "y" ] }'], [
        '{ "age" : 1 , "name" : "a" , "tags" : [ "x" , "y" , "z" ] }']),
    "prop_order_controls_sequence": (SCHEMA, {"prop_order": ["name"]}, [
        '{ "name" : "bo" , "age" : 3 }'], ['{ "age" : 3 , "name" : "bo" }']),
    "oneof_const_ref_prefixitems": ({
        "$defs": {"coord": {"type": "array",
                            "prefixItems": [{"type": "number"}, {"type": "number"}]}},
        "oneOf": [{"const": "origin"}, {"$ref": "#/$defs/coord"}],
    }, {}, ['"origin"', "[ 1.5 , -2 ]"], ["[ 1.5 ]", '"elsewhere"']),
    "min_items": ({"type": "array", "items": {"type": "integer"}, "minItems": 2}, {},
                  ["[ 1 , 2 ]", "[ 1 , 2 , 3 ]"], ["[ 1 ]"]),
    "all_optional_object": ({
        "type": "object",
        "properties": {"a": {"type": "integer"}, "b": {"type": "integer"},
                       "c": {"type": "integer"}},
        "required": [],
    }, {}, ["{ }", '{ "a" : 1 }', '{ "b" : 2 }', '{ "c" : 3 }', '{ "a" : 1 , "c" : 3 }',
            '{ "b" : 2 , "c" : 3 }', '{ "a" : 1 , "b" : 2 , "c" : 3 }'],
        ['{ , "b" : 2 }', '{ "a" : 1 , }', '{ "c" : 3 , "a" : 1 }']),
    "recursive_ref": ({
        "$defs": {"node": {"type": "object",
                           "properties": {"v": {"type": "integer"},
                                          "next": {"$ref": "#/$defs/node"}},
                           "required": ["v"]}},
        "$ref": "#/$defs/node",
    }, {}, ['{ "v" : 1 }', '{ "v" : 1 , "next" : { "v" : 2 , "next" : { "v" : 3 } } }'],
        ['{ "next" : { "v" : 2 } }']),
    "unconstrained_schema_any_value": ({}, {}, [
        '{ "k" : [ 1 , true , null ] }', '"s"', "3.5", "[ ]"], []),
}


@pytest.mark.parametrize("name", list(CASES))
def test_schema_grammar_matches_jax(name):
    schema, kw, ok, bad = CASES[name]
    g = schema_to_gbnf(schema, **kw)
    assert g == j_schema_to_gbnf(schema, **kw)
    for text in ok:
        assert _accepts(g, text), text
    for text in bad:
        assert not _accepts(g, text), text


@pytest.mark.parametrize("name,ok,bad", [
    ("json.gbnf", '{ "a": [1, 2.5, "x"], "b": null }', '{ "a": }'),
    ("json_arr.gbnf", '[1, {"k": "v"}, false]', '{"k": 1}'),
    ("arithmetic.gbnf", "x+1*(y-2)=z\n", "x++1=\n"),
    ("list.gbnf", "- one\n- two\n", "* one\n"),
    ("chess.gbnf", "1. e4 e5\n2. Nf3 Nc6\n", "1. z9 e5\n"),
])
def test_sample_grammars(name, ok, bad):
    text = (GRAMMARS_DIR / name).read_text()
    assert _accepts(text, ok), f"{name} should accept {ok!r}"
    assert not _accepts(text, bad), f"{name} should reject {bad!r}"


def test_cli_prints_the_jax_grammar(tmp_path, capsys):
    """`python -m pipeinfer_tpu_torch.tools.json_schema schema.json` prints
    what the JAX package's CLI prints."""
    import json

    from pipeinfer_tpu.tools import json_schema as j_json_schema
    from pipeinfer_tpu_torch.tools import json_schema

    path = tmp_path / "s.json"
    path.write_text(json.dumps(SCHEMA))
    outs = []
    for mod in (json_schema, j_json_schema):
        rc = mod.main([str(path), "--prop-order", "name,age"])
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][1]
