"""The port's CLIs and tokenizer against the JAX package's, on the CPU.

The nano bench pair carries a synthetic SPM vocabulary
(tools/testmodel.synthetic_spm_vocab; no vocabulary file is needed), so
both packages' `main` and `speculative` run on the same two files. Greedy
decoding on the pair's logit margin makes the printed text a strict
comparison: the port (`--device cpu`, the kernels' plain versions) must
print the JAX package's stdout byte for byte, under the default layout
(k_major off the accelerator in both packages) and under i4g, for every
engine (the device loop too, also where --engine auto picks it); an
engine the port does not have yet must exit with an error naming its
ROADMAP.md item by its title. The staged pipeline's CLIs (`cli.pipeline`, and
`cli.speculative --stages 2`) and `cli.lookahead` print the JAX package's
text too.
"""

import contextlib
import dataclasses
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pipeinfer_tpu.cli import lookahead as j_lookahead
from pipeinfer_tpu.cli import main as j_main
from pipeinfer_tpu.cli import pipeline as j_pipeline
from pipeinfer_tpu.cli import speculative as j_spec
from pipeinfer_tpu.gguf.constants import GGMLQuantType as JQ
from pipeinfer_tpu.gguf.reader import GGUFReader as JReader
from pipeinfer_tpu.models import loader as j_loader
from pipeinfer_tpu.tokenizer import tokenizer_from_gguf as j_tokenizer
from pipeinfer_tpu.tokenizer.stream import StreamDecoder as JStream
from pipeinfer_tpu_torch.cli import lookahead as t_lookahead
from pipeinfer_tpu_torch.cli import main as t_main
from pipeinfer_tpu_torch.cli import pipeline as t_pipeline
from pipeinfer_tpu_torch.cli import speculative as t_spec
from pipeinfer_tpu_torch.gguf.constants import GGMLQuantType as TQ
from pipeinfer_tpu_torch.gguf.reader import GGUFReader as TReader
from pipeinfer_tpu_torch.models import loader as t_loader
from pipeinfer_tpu_torch.parallel.stages import StagedInferenceContext
from pipeinfer_tpu_torch.runtime.context import InferenceContext
from pipeinfer_tpu_torch.sampling.samplers import SamplerState, SamplingParams
from pipeinfer_tpu_torch.tokenizer import tokenizer_from_gguf as t_tokenizer
from pipeinfer_tpu_torch.tokenizer.stream import StreamDecoder as TStream
from pipeinfer_tpu_torch.tools import testmodel

# The suite runs as several test processes on one machine, and torch's
# OpenMP pools spin-wait: two processes decoding at once with a full pool
# each starve one another by orders of magnitude. Every process collects
# this module, so this keeps each one's torch to one thread.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "Once upon a time, in 2024: héllo! 日本"
SPEC_CASES = {
    "controller_np1": ["--engine", "controller", "-np", "1", "--draft", "6"],  # corrected
    "trees_np3": ["--draft", "4"],  # the default -np 3: host-verified trees
    "auto_np3": ["--engine", "auto", "--draft", "4"],  # auto keeps the controller for trees
    "sync": ["--engine", "sync", "-np", "1"],
    "device_loop": ["--engine", "device-loop", "-np", "1", "--draft", "6"],
    "auto_np1": ["--engine", "auto", "-np", "1", "--draft", "6"],  # auto picks the device loop
}
# the staged pipeline's and lookahead's CLIs: (JAX entry, port entry, extra argv)
STAGED_CASES = {
    "pipeline_2": (j_pipeline.main, t_pipeline.main, ["--layer-split", "0.5,0.5"]),
    "pipeline_3_weighted": (j_pipeline.main, t_pipeline.main, ["--layer-split", "0.25,0.25,0.5"]),
    "lookahead": (j_lookahead.main, t_lookahead.main, ["-W", "6", "-N", "4", "-G", "8"]),
    "lookahead_defaults": (j_lookahead.main, t_lookahead.main, []),
    "speculative_stages2": (j_spec.main, t_spec.main,
                            ["--stages", "2", "--engine", "controller", "-np", "1"]),
    "speculative_stages2_trees": (j_spec.main, t_spec.main, ["--stages", "2", "--draft", "4"]),
    "speculative_stages2_auto": (j_spec.main, t_spec.main,
                                 ["--stages", "2", "--engine", "auto", "-np", "1"]),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    tgt, dft = d / "t.gguf", d / "d.gguf"
    testmodel.build_bench_pair(tgt, dft, scale="nano", eps=0.5, vocab=True)
    return str(tgt), str(dft)


def _greedy(pair, n=48):
    return ["-m", pair[0], "-p", PROMPT, "-n", str(n), "--temp", "0", "--repeat-penalty", "1.0",
            "--repeat-last-n", "0", "--ignore-eos", "-c", "256"]


def _stdout(entry, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert entry(argv) == 0
    return buf.getvalue()


def _tokenizers(path):
    with JReader(path) as r:
        jt = j_tokenizer(r)
    with TReader(path) as r:
        tt = t_tokenizer(r)
    return jt, tt


def test_tokenizer_matches_jax(pair):
    """Encode (with and without BOS), byte fallback, decode and the
    streaming decoder agree token for token and byte for byte."""
    jt, tt = _tokenizers(pair[0])
    assert dataclasses.asdict(tt.vocab) == dataclasses.asdict(jt.vocab)
    assert tt.vocab.n_vocab == 2048
    texts = ["", "hello world", " leading space", PROMPT, "日本語 🙂 tabs\tand\nnewlines",
             "zzqx qqq vvv", "ALL CAPS, digits 0123 and ~punctuation~"]
    for text in texts:
        for bos in (True, False):
            assert tt.encode(text, add_bos=bos) == jt.encode(text, add_bos=bos), text
    ids = tt.encode("日本 é", add_bos=False)
    assert sum(3 <= i < 259 for i in ids) >= 7  # UTF-8 bytes through <0xNN> tokens
    assert tt.decode(ids) == jt.decode(ids) and "日本 é" in tt.decode(ids)
    rng = np.random.default_rng(5)
    for _ in range(20):
        ids = rng.integers(0, 2048, 40).tolist()
        assert tt.decode(ids) == jt.decode(ids)
    ids = tt.encode("a日🙂b", add_bos=True) + rng.integers(0, 2048, 60).tolist()
    js, ts = JStream(jt), TStream(tt)
    assert [ts.feed(i) for i in ids] == [js.feed(i) for i in ids]
    assert ts.flush() == js.flush()


def test_default_layout_is_k_major_on_the_cpu(monkeypatch):
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    assert j_loader.matmul_layout(JQ.Q4_K) == "k_major"  # the JAX package off the TPU
    for q in (TQ.Q4_K, TQ.Q6_K):
        assert t_loader.matmul_layout(q, "cpu") == "k_major"
    assert t_loader.matmul_layout(TQ.Q4_K, "cuda") == "i4g"
    assert t_loader.matmul_layout(TQ.Q6_K, "cuda") == "i8g"
    for env in ("k_major", "i8", "k4", "i8g", "i4g"):
        monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", env)
        assert t_loader.matmul_layout(TQ.Q4_K, "cuda") == t_loader.matmul_layout(None, "cpu") == env


@pytest.mark.parametrize("layout", ["default", "i4g"])
@pytest.mark.parametrize("case", ["main", *SPEC_CASES])
def test_port_cli_prints_the_jax_stdout(pair, layout, case, monkeypatch):
    """Each engine prints the JAX package's text, which is also the plain
    greedy text of `main` (speculation never changes a greedy stream)."""
    if layout == "default":
        monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    if case == "main":
        argv, j_entry, t_entry = _greedy(pair), j_main.main, t_main.main
    else:
        argv, j_entry, t_entry = _greedy(pair) + ["-md", pair[1], *SPEC_CASES[case]], \
            j_spec.main, t_spec.main
    want = _stdout(j_entry, argv)
    got = _stdout(t_entry, argv + ["--device", "cpu"])
    assert got == want
    plain = _stdout(t_main.main, _greedy(pair) + ["--device", "cpu"])
    assert got == plain and len(got) > len(PROMPT) + 48


def test_grammar_run_matches_jax(pair, monkeypatch):
    """A GBNF grammar masks the verifier's samples (and the drafts): the
    same constrained text in both packages, only letters and spaces."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = _greedy(pair, n=8) + ["-md", pair[1], "--engine", "controller", "-np", "1",
                                 "--grammar", "root ::= [a-z ]+"]
    want = _stdout(j_spec.main, argv)
    got = _stdout(t_spec.main, argv + ["--device", "cpu"])
    assert got == want
    prompt_text = _stdout(t_main.main, _greedy(pair, n=0) + ["--device", "cpu"])[:-1]
    generated = got[len(prompt_text):-1]
    assert generated and set(generated) <= set("abcdefghijklmnopqrstuvwxyz ")


def test_module_entry_runs_as_a_program(pair):
    """`python -m pipeinfer_tpu_torch.cli.speculative` in a process of its
    own prints what the in-process call prints."""
    argv = _greedy(pair, n=16) + ["-md", pair[1], "--engine", "controller", "-np", "1",
                                  "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.cli.speculative", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _stdout(t_spec.main, argv)
    assert "n_accept" in out.stderr


@pytest.fixture(scope="module")
def adapter(pair, tmp_path_factory):
    """A LoRA adapter over the nano target's default slots (wq, wk, wv, wo)
    with non-zero B: its wo delta lets attention reach the logits, which
    the pair's zero wo keeps out."""
    from pipeinfer_tpu_torch.models import load_model
    from pipeinfer_tpu_torch.tools import lora

    params, _ = load_model(pair[0], device="cpu", fuse=False)
    factors = lora.init_lora(params, 4, lora.DEFAULT_TARGETS, seed=9)
    g = torch.Generator().manual_seed(9)
    factors = [{s: (a, torch.randn(b.shape, generator=g) * 0.5) for s, (a, b) in e.items()}
               for e in factors]
    path = tmp_path_factory.mktemp("torch_cli_lora") / "a.gguf"
    lora.save_adapter(path, factors, rank=4, alpha=8.0)
    return str(path)


@pytest.mark.parametrize("layout", ["default", "k4"])
@pytest.mark.parametrize("lora_args", [["--lora", "{a}"], ["--lora-scaled", "{a}", "0.5"],
                                       ["--lora", "{a}", "--lora-scaled", "{a}", "-1.5"]])
def test_main_lora_prints_the_jax_stdout(pair, adapter, layout, lora_args, monkeypatch):
    """--lora / --lora-scaled merge the adapter at load in both packages:
    the port prints the JAX package's text, and the adapter changes it.
    Under the exact layouts only: the adapter's wo delta brings attention
    into the logits, where i4g's plane refit and the port's s8 activations
    on the CPU (ROADMAP.md queue 3) move them off the pair's wide margin."""
    if layout == "default":
        monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("PIPEINFER_WEIGHT_LAYOUT", layout)
    argv = _greedy(pair, n=24) + [x.format(a=adapter) for x in lora_args]
    want = _stdout(j_main.main, argv)
    got = _stdout(t_main.main, argv + ["--device", "cpu"])
    assert got == want
    assert got != _stdout(t_main.main, _greedy(pair, n=24) + ["--device", "cpu"])


def _run(entry, argv) -> tuple[str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert entry(argv) == 0
    return out.getvalue(), err.getvalue()


def test_main_prompt_cache_matches_jax(pair, tmp_path, monkeypatch):
    """--prompt-cache: the first run prefills the prompt and saves the
    session, the second restores it and decodes only the last prompt token
    again; both print the JAX package's text (each package on its own
    session file), and the port resumes from the JAX package's file too."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    argv = _greedy(pair, n=16)
    n_prompt = len(_tokenizers(pair[0])[1].encode(PROMPT, add_bos=True))
    j_file, t_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.bin")
    want = [_stdout(j_main.main, argv + ["--prompt-cache", j_file]) for _ in range(2)]
    runs = [_run(t_main.main, argv + ["--prompt-cache", t_file, "--device", "cpu"])
            for _ in range(2)]
    assert want[0] == want[1] == runs[0][0] == runs[1][0]
    assert f"prefill: {n_prompt} tokens" in runs[0][1]
    assert "prefill:" not in runs[1][1] and "decode:  17 tokens" in runs[1][1]
    assert Path(t_file).exists()  # written under the name given
    got, err = _run(t_main.main, argv + ["--prompt-cache", j_file, "--device", "cpu"])
    assert got == want[0] and "prefill:" not in err


def test_main_prompt_cache_ignores_another_prompt_or_shape(pair, tmp_path, monkeypatch):
    """A session of another prompt is dropped (a full prefill follows), one
    of another cell count is ignored with a note; the text is cli.main's."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    f = str(tmp_path / "s.npz")
    _run(t_main.main, _greedy(pair, n=4) + ["-p", "zz top", "--prompt-cache", f, "--device",
                                            "cpu"])
    plain = _stdout(t_main.main, _greedy(pair, n=8) + ["--device", "cpu"])
    got, err = _run(t_main.main, _greedy(pair, n=8) + ["--prompt-cache", f, "--device", "cpu"])
    assert got == plain and "prefill:" in err
    got, err = _run(t_main.main, _greedy(pair, n=8) + ["-c", "1024", "--prompt-cache", f,
                                                       "--device", "cpu"])
    assert got == plain and "prompt-cache ignored" in err and "shape mismatch" in err


def test_tensor_parallel_stages_generate_as_one_device(pair):
    """2 stages x 2-way TP (StagedInferenceContext(tp=2), which the CLIs do
    not expose, as the JAX package's do not) generate through cli.main's
    generate loop the tokens one device generates on the nano pair."""
    params, cfg = t_loader.load_model(pair[0], device="cpu")
    with TReader(pair[0]) as r:
        ids = t_tokenizer(r).encode(PROMPT, add_bos=True)
    out = []
    for ctx in (InferenceContext(params, cfg, n_cells=256, device="cpu"),
                StagedInferenceContext(params, cfg, n_cells=256, devices=["cpu"] * 4, tp=2)):
        sampler = SamplerState(params=SamplingParams(temp=0.0, penalty_repeat=1.0,
                                                     penalty_last_n=0))
        out.append(t_main.generate(ctx, None, sampler, ids, 24, ignore_eos=True))
    assert out[0] == out[1] and len(out[0]) == 24


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_and_lookahead_clis_print_the_jax_stdout(pair, case, monkeypatch):
    """cli.pipeline over 2 and 3 stages, cli.lookahead and cli.speculative
    --stages 2 (the controller; --engine auto keeps it for a staged target)
    print the JAX package's text, which is cli.main's greedy text."""
    monkeypatch.delenv("PIPEINFER_WEIGHT_LAYOUT", raising=False)
    j_entry, t_entry, extra = STAGED_CASES[case]
    argv = _greedy(pair) + (["-md", pair[1]] if t_entry is t_spec.main else []) + extra
    want = _stdout(j_entry, argv)
    got = _stdout(t_entry, argv + ["--device", "cpu"])
    assert got == want
    assert got == _stdout(t_main.main, _greedy(pair) + ["--device", "cpu"])


def test_pipeline_module_runs_as_a_program(pair):
    """`python -m pipeinfer_tpu_torch.cli.pipeline` in a process of its own
    prints what the in-process call prints, and names its stages."""
    argv = _greedy(pair, n=16) + ["--layer-split", "0.5,0.5", "--device", "cpu"]
    out = subprocess.run([sys.executable, "-m", "pipeinfer_tpu_torch.cli.pipeline", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _stdout(t_pipeline.main, argv)
    assert "pipeline: 2 stages, layer ranges [(0, 2), (2, 4)]" in out.stderr
