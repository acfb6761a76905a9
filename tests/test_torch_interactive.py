"""The port's interactive, instruct and ChatML chat loop, infill, --logdir
and --profile against the JAX package's, on the CPU.

The model is a tiny random llama (attention and the FFN reach the logits)
with the nano bench pair's synthetic SPM vocabulary, f32 weights and an f32
cache, so both packages compute the same greedy stream: each case runs
both packages' `interactive_loop` (or `cli.main`) on the same scripted
input and compares the generated ids and every written string, byte for
byte. Where the stdin path matters (--color, ctrl-C scope) the CLIs read a
scripted sys.stdin.
"""

import argparse
import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pipeinfer_tpu.cli import main as j_main
from pipeinfer_tpu.models import load_model as j_load
from pipeinfer_tpu.runtime.context import InferenceContext as JContext
from pipeinfer_tpu.sampling.samplers import SamplerState as JSampler
from pipeinfer_tpu.sampling.samplers import SamplingParams as JParams
from pipeinfer_tpu_torch.cli import infill as t_infill
from pipeinfer_tpu_torch.cli import main as t_main
from pipeinfer_tpu_torch.gguf.reader import GGUFReader
from pipeinfer_tpu_torch.models import load_model as t_load
from pipeinfer_tpu_torch.runtime.context import InferenceContext as TContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState as TSampler
from pipeinfer_tpu_torch.sampling.samplers import SamplingParams as TParams
from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf
from pipeinfer_tpu_torch.tools import testmodel

torch.set_num_threads(1)

GREEDY = dict(temp=0.0, penalty_repeat=1.0, penalty_last_n=0)
GREEDY_ARGV = ["--temp", "0", "--repeat-penalty", "1.0", "--repeat-last-n", "0"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(path, JAX params and config, port params and config, tokenizer,
    FIM copy's path) of the tiny llama with a synthetic vocabulary."""
    d = tmp_path_factory.mktemp("torch_interactive")
    testmodel.build_bench_pair(d / "nt.gguf", d / "nd.gguf", scale="nano", eps=0.5, vocab=True)
    path = testmodel.build_tiny_llama(d / "tiny.gguf", seed=9, n_layers=2, n_embd=64,
                                      n_heads=4, n_kv_heads=2, n_ff=128,
                                      vocab_from=d / "nt.gguf")
    fim = testmodel.with_fim_ids(path, d / "tiny_fim.gguf")
    with GGUFReader(path) as r:
        tok = tokenizer_from_gguf(r)
    return dict(path=str(path), fim=str(fim), j=j_load(path), t=t_load(path, device="cpu"),
                tok=tok)


def args_ns(**kw):
    base = dict(
        interactive=True, interactive_first=False, instruct=False,
        chatml=False, reverse_prompt=[], in_prefix="", in_suffix="",
        input_prefix_bos=False, keep=-1, n_predict=4, ignore_eos=False,
        color=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def scripted(lines):
    it = iter(lines)

    def fn():
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    return fn


def _ctx(model, side, n_cells):
    import jax.numpy as jnp

    if side == "j":
        params, cfg = model["j"]
        return JContext(params, cfg, n_cells=n_cells, cache_dtype=jnp.float32)
    params, cfg = model["t"]
    return TContext(params, cfg, n_cells=n_cells, cache_dtype=torch.float32, device="cpu")


def run_loops(model, prompt, args, lines, n_cells=256):
    """Both packages' interactive_loop on the same scripted input: a dict
    side -> (generated ids, written strings, the context)."""
    tok = model["tok"]
    ids = tok.encode(prompt, add_bos=True)
    out = {}
    for side, loop, sampler in (("j", j_main.interactive_loop, JSampler(params=JParams(**GREEDY))),
                                ("t", t_main.interactive_loop,
                                 TSampler(params=TParams(**GREEDY)))):
        ctx = _ctx(model, side, n_cells)
        writes = []
        got = loop(ctx, tok, sampler, ids, args, input_fn=scripted(lines), write=writes.append)
        out[side] = (got, writes, ctx)
    return out


def assert_same(out):
    assert out["t"][0] == out["j"][0]
    assert out["t"][1] == out["j"][1]


def test_turn_budget_and_eof(model):
    """Each turn generates n_predict tokens, then control returns; EOF ends:
    the port's turns are the JAX package's."""
    out = run_loops(model, "once upon", args_ns(n_predict=4), ["hello there", ""])
    assert_same(out)
    got = out["t"][0]
    eos = model["tok"].vocab.eos_id
    # 3 turns (initial gen + 1 input + 1 empty pass-back), 4 tokens each,
    # unless EOS lands early
    assert 4 <= len(got) <= 12 and (len([t for t in got if t != eos]) >= 4 or eos in got)


def test_first_turn_matches_plain_generate(model):
    """Before any user input, the interactive loop greedy-decodes exactly
    the tokens plain generate() produces, in both packages."""
    tok = model["tok"]
    prompt = tok.encode("the quick brown", add_bos=True)
    ref = t_main.generate(_ctx(model, "t", 256), tok, TSampler(params=TParams(**GREEDY)),
                          prompt, 6, ignore_eos=True)
    out = run_loops(model, "the quick brown", args_ns(n_predict=6, ignore_eos=True), [])
    assert_same(out)
    assert out["t"][0] == ref and len(ref) == 6


def test_reverse_prompt_stops_generation(model):
    """An antiprompt equal to the third generated piece pauses after it,
    well before the budget, as in the JAX package."""
    tok = model["tok"]
    prompt = "hello"
    ref = t_main.generate(_ctx(model, "t", 256), tok, TSampler(params=TParams(**GREEDY)),
                          tok.encode(prompt, add_bos=True), 12, ignore_eos=True)
    anti = tok.decode(ref[2:3])
    assert anti.strip(), "the third greedy piece must be visible text"
    out = run_loops(model, prompt, args_ns(n_predict=12, ignore_eos=True, reverse_prompt=[anti]),
                    [])
    assert_same(out)
    assert len(out["t"][0]) < 12 and anti in tok.decode(out["t"][0])


MODES = {
    "instruct": dict(instruct=True, interactive_first=True, n_predict=3),
    "chatml": dict(chatml=True, n_predict=3),
    "interactive_first": dict(interactive_first=True, n_predict=5),
    "prefix_suffix_bos": dict(n_predict=2, in_prefix="user: ", in_suffix="bot: ",
                              input_prefix_bos=True),
    "instruct_prefix": dict(instruct=True, n_predict=3, in_prefix="q: ", in_suffix="a: "),
    "chatml_keep": dict(chatml=True, n_predict=4, keep=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax(model, mode):
    """instruct, ChatML, --interactive-first and --in-prefix/--in-suffix/
    --in-prefix-bos: the same ids and the same written text (the '> '
    prompts, prefixes and suffixes) as the JAX package, over two turns and
    an empty line."""
    out = run_loops(model, "below is an instruction", args_ns(**MODES[mode]),
                    ["say hi", "", "and again"])
    assert_same(out)
    joined = "".join(out["t"][1])
    if MODES[mode].get("instruct") or MODES[mode].get("chatml"):
        assert "\n> " in joined
    if MODES[mode].get("in_prefix"):
        assert MODES[mode]["in_prefix"] in joined and MODES[mode]["in_suffix"] in joined
    assert len(out["t"][0]) >= MODES[mode]["n_predict"]


def test_slide_if_full_on_a_small_pool(model):
    """A 40-cell pool fills during the turns: _slide_if_full discards half
    of what is past n_keep and shifts the rest (K re-rotated) in both
    packages, which then generate the same ids; the pool never overflows."""
    args = args_ns(n_predict=10, ignore_eos=True, keep=3)
    lines = ["tell me a story", "more please", "and more", "again"]
    out = run_loops(model, "once upon a time", args, lines, n_cells=40)
    assert_same(out)
    assert len(out["t"][0]) == 5 * 10
    ctx = out["t"][2]
    assert ctx.n_free_cells >= 0
    pos = ctx.h_pos[ctx.h_pos >= 0]
    assert len(pos) < 39 and pos.max() < len(out["t"][0])  # positions shifted down


def test_slide_if_full_matches_jax_directly(model):
    """_slide_if_full itself: the same positions kept in the host mirror,
    and the same logits after it (re-rotated K), as the JAX package's."""
    tok = model["tok"]
    ids = tok.encode("a b c d e f g h i j k l m n o p q r s t", add_bos=True)
    res = {}
    for side, mod in (("j", j_main), ("t", t_main)):
        ctx = _ctx(model, side, 24)
        from pipeinfer_tpu.runtime.context import Batch as JB
        from pipeinfer_tpu_torch.runtime.context import Batch as TB

        b = (JB if side == "j" else TB)()
        n = min(len(ids), 22)
        for i in range(n):
            b.add(ids[i], i, 0, want_logits=False)
        ctx.decode(b)
        n_past = mod._slide_if_full(ctx, n, 2, need=4)
        b = (JB if side == "j" else TB)()
        b.add(ids[0], n_past, 0)
        res[side] = (n_past, np.sort(np.asarray(ctx.h_pos)[np.asarray(ctx.h_pos) >= 0]),
                     np.asarray(ctx.decode(b)[0]))
    assert res["t"][0] == res["j"][0] < 22
    np.testing.assert_array_equal(res["t"][1], res["j"][1])
    np.testing.assert_allclose(res["t"][2], res["j"][2], rtol=0, atol=1e-5)


def _cli(entry, argv, stdin=None, monkeypatch=None):
    out, err = io.StringIO(), io.StringIO()
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = entry(argv)
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "interactive": ["-i", "-n", "6"],
    "interactive_first_color": ["--interactive-first", "--color", "-n", "5"],
    "instruct": ["--instruct", "-n", "4"],
    "chatml_prefix": ["--chatml", "--in-prefix", "me: ", "--in-suffix", "you: ", "-n", "4"],
    "reverse_prompt_bos": ["-i", "-r", "xt", "--in-prefix-bos", "-n", "8"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_main_interactive_prints_the_jax_stdout(model, case, monkeypatch):
    """cli.main in the chat modes, reading a scripted stdin (two turns,
    then EOF): the port prints the JAX package's stdout byte for byte
    (--color's escape codes included)."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = ["-m", model["path"], "-p", "once upon a time", "-c", "256", "--cache-dtype", "f32",
            *GREEDY_ARGV, *CLI_CASES[case]]
    stdin = "tell me more\nwhat next\n"
    rc_j, want, _ = _cli(j_main.main, argv, stdin, monkeypatch)
    rc_t, got, err = _cli(t_main.main, argv + ["--device", "cpu"], stdin, monkeypatch)
    assert rc_j == rc_t == 0
    assert got == want
    if "--color" in CLI_CASES[case]:
        assert t_main._ANSI_USER in got and t_main._ANSI_RESET in got
    assert "decode:" in err


def test_first_interactive_turn_is_plain_greedy_text(model, monkeypatch):
    """cli.main -i with EOF at the first read prints, after the prompt,
    what the one-shot cli.main prints for the same budget."""
    base = ["-m", model["path"], "-p", "the sea", "-c", "256", "--cache-dtype", "f32",
            *GREEDY_ARGV, "-n", "8", "--ignore-eos", "--device", "cpu"]
    _, plain, _ = _cli(t_main.main, base)
    _, chat, _ = _cli(t_main.main, base + ["-i"], "", monkeypatch)
    assert chat == plain


@pytest.mark.parametrize("fim", [("def f(x):", "return y"), ("", "tail only"), ("head", None)])
def test_fim_prompt_matches_jax(model, fim, monkeypatch):
    """--fim-prefix/--fim-suffix assemble <bos><PRE>prefix<SUF>suffix<MID>
    over a vocabulary with FIM ids: the port prints the JAX package's text."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = ["-m", model["fim"], "-c", "256", "-n", "12", *GREEDY_ARGV]
    if fim[0] is not None:
        argv += ["--fim-prefix", fim[0]]
    if fim[1] is not None:
        argv += ["--fim-suffix", fim[1]]
    _, want, _ = _cli(j_main.main, argv)
    _, got, _ = _cli(t_main.main, argv + ["--device", "cpu"])
    assert got == want
    with GGUFReader(model["fim"]) as r:
        v = tokenizer_from_gguf(r).vocab
    assert (v.fim_pre, v.fim_suf, v.fim_mid) == (2045, 2046, 2047)


def test_fim_needs_fim_ids(model):
    """A vocabulary without FIM ids: both packages exit with one message."""
    argv = ["-m", model["path"], "--fim-prefix", "x", "-n", "2"]
    with pytest.raises(SystemExit) as ej:
        j_main.main(argv)
    with pytest.raises(SystemExit) as et:
        t_main.main(argv + ["--device", "cpu"])
    assert str(et.value.code) == str(ej.value.code) and "fill-in-middle" in str(et.value.code)


def test_infill_argument_errors_and_run(model, monkeypatch):
    """cli.infill: no --in-prefix / --in-suffix returns 1 with the JAX
    package's message; one side given, the other is added empty and
    cli.main runs, printing the JAX package's cli.infill text."""
    from pipeinfer_tpu.cli import infill as j_infill

    rc, out, err = _cli(t_infill.main, ["-m", model["fim"], "--device", "cpu"])
    rc_j, _, err_j = _cli(j_infill.main, ["-m", model["fim"]])
    assert rc == rc_j == 1 and err == err_j and "infill needs" in err
    for extra in (["--in-prefix", "def f("], ["--in-suffix", "return"],
                  ["--in-prefix", "a", "--in-suffix", "b"]):
        argv = ["-m", model["fim"], "-p", "code", "-c", "256", "-n", "6", *GREEDY_ARGV, *extra]
        rc_j, want, _ = _cli(j_infill.main, argv)
        rc_t, got, _ = _cli(t_infill.main, argv + ["--device", "cpu"])
        assert rc_j == rc_t == 0 and got == want


def test_logdir_yaml_matches_jax(model, tmp_path, monkeypatch):
    """--logdir writes one YAML run dump whose params (the port's --device
    aside), prompt and output tokens and text are the JAX package's; the
    timing fields are each run's own."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    docs = {}
    for side, entry, extra in (("j", j_main.main, []), ("t", t_main.main, ["--device", "cpu"])):
        d = tmp_path / side
        argv = ["-m", model["path"], "-p", "once upon", "-c", "256", "-n", "10", *GREEDY_ARGV,
                "--logdir", str(d), *extra]
        _, out, err = _cli(entry, argv)
        files = list(d.glob("run-*.yml"))
        assert len(files) == 1 and f"run dump: {files[0]}" in err
        docs[side] = yaml.safe_load(files[0].read_text())
        docs[side]["params"].pop("logdir")
    t, j = docs["t"], docs["j"]
    assert t["params"].pop("device") == "cpu"
    assert t["params"] == j["params"]
    for k in ("prompt_tokens", "output_tokens", "output", "build_info"):
        assert t[k] == j[k]
    assert set(t["timings"]) == set(j["timings"])
    assert t["timings"]["n_eval"] == j["timings"]["n_eval"] == 10
    assert len(t["output_tokens"]) == 10


def test_profile_writes_a_trace_and_the_same_text(model, tmp_path, monkeypatch):
    """--profile DIR: the port writes a torch.profiler trace into DIR, says
    so on stderr as the JAX package does, and prints the JAX package's
    text (the JAX run without the profiler: jax.profiler is not needed to
    hold the text)."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = ["-m", model["path"], "-p", "once upon", "-c", "256", "-n", "8", *GREEDY_ARGV]
    _, want, _ = _cli(j_main.main, argv)
    trace = tmp_path / "trace"
    _, got, err = _cli(t_main.main, argv + ["--profile", str(trace), "--device", "cpu"])
    assert got == want
    assert f"profile trace -> {trace}" in err
    files = list(Path(trace).glob("*.json"))
    assert files and files[0].stat().st_size > 1000
    assert "qmatmul" in files[0].read_text() or "aten::" in files[0].read_text()
